"""Single-file HTML pipeline report (a copy of ``stereo_reconstruction_cv_tpu/io/report.py``).

Every stage's imagery embedded as base64 PNG, the numbers as text, and the
point-cloud viewer in an iframe: what ``cli report PAIR`` writes. PNG
encoding goes through PIL, imported where it is used.
"""

from __future__ import annotations

import base64
import html
import io as _io

import numpy as np

_PAGE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>{title}</title>
<style>
 body {{ font: 14px system-ui, sans-serif; margin: 2em auto; max-width: 1280px;
        background: #fafafa; color: #222; }}
 h1 {{ font-size: 1.4em; }} h2 {{ font-size: 1.1em; margin-top: 2em;
      border-bottom: 1px solid #ddd; padding-bottom: .3em; }}
 img {{ max-width: 100%; border: 1px solid #ccc; border-radius: 4px; }}
 .grid {{ display: grid; grid-template-columns: 1fr 1fr; gap: 12px; }}
 pre {{ background: #f0f0f0; padding: .8em; border-radius: 4px;
       overflow-x: auto; }}
 .viewer {{ width: 100%; height: 540px; border: 1px solid #ccc;
           border-radius: 4px; }}
</style></head><body>
<h1>{title}</h1>
{body}
</body></html>
"""


def _png_b64(img: np.ndarray) -> str:
    from PIL import Image

    img = np.asarray(img)
    if img.dtype != np.uint8:
        img = np.clip(img, 0, 255).astype(np.uint8)
    buf = _io.BytesIO()
    Image.fromarray(img).save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode()


class ReportBuilder:
    def __init__(self, title: str):
        self.title = title
        self.parts: list[str] = []

    def section(self, name: str):
        self.parts.append(f"<h2>{html.escape(name)}</h2>")
        return self

    def text(self, s: str):
        self.parts.append(f"<p>{html.escape(s)}</p>")
        return self

    def pre(self, s: str):
        self.parts.append(f"<pre>{html.escape(s)}</pre>")
        return self

    def images(self, items):
        """items: list of (caption, ndarray image)."""
        cells = []
        for cap, img in items:
            cells.append(
                f"<figure><img src='data:image/png;base64,{_png_b64(img)}'/>"
                f"<figcaption>{html.escape(cap)}</figcaption></figure>"
            )
        self.parts.append(f"<div class='grid'>{''.join(cells)}</div>")
        return self

    def viewer(self, viewer_html_path: str):
        """Embed an io.viewer HTML file as an iframe (srcdoc keeps the
        report self-contained)."""
        with open(viewer_html_path) as f:
            doc = f.read()
        esc = html.escape(doc, quote=True)
        self.parts.append(f"<iframe class='viewer' srcdoc=\"{esc}\"></iframe>")
        return self

    def write(self, path: str) -> str:
        with open(path, "w") as f:
            f.write(_PAGE.format(title=html.escape(self.title),
                                 body="\n".join(self.parts)))
        return path

"""The parent/new comparison tool's log reader, on lines as chip_smoke.py
prints them (the runs themselves need a card)."""

import json
import os

import pytest

from stereo_reconstruction_cv_tpu_torch.tools import compare_smoke as CS

LOG = "\n".join([
    "nvidia-smi: NVIDIA H100 80GB HBM3, 700.00 W",
    "built CUDA kernels in 31.8 s, host speckle in 1.2 s",
    "[720p 720x1280x128 md=0] cost_volume: equal; kernel 2.372 ms, plain 16.393 ms",
    "[720p 8-dir] sgm_path_sweep x7: equal; kernel 5.329 ms, plain 632.056 ms",
    '[720p 720x1152x128] sgm_path_sweep per direction: {"1,0": {"ms": 1.5, "steps": 1152, '
    '"paths": 720, "us_per_step": 1.3}}',
    "[720p 8-dir] sgm_sweep_wta: equal (disp, valid, best, minS); kernel 1.222 ms, plain 9 ms; "
    "valid share 1.0",
    "sgbm_disparity 720p x128 8-dir (device speckle): s/pair first 0.01, warm [0.0096] "
    "(warm median 0.0096 s, 95.2 MPix/s); valid 1.0000",
    "4K device chain 3840x2160 x256 5-dir: s/pair first (cold) 0.085, warm [0.086] "
    "(warm median 0.0861 s, 96.3 MPix/s); masked point sum 1.0",
    '4K disparity breakdown (ms): {"cost_volume": 27.6, "sgm_path_sweep x4": 38.65}',
    json.dumps({"kernels": [{"name": "cost_volume", "ms": 2.37}]}),
    "NVIDIA H100 80GB HBM3, 700.00 W",
    '{"ok": true, "device": {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1}}',
])


def test_parse_reads_every_number():
    got = CS.parse(LOG)
    assert got == {
        "card": "NVIDIA H100 80GB HBM3, 700.00 W",
        "build s": 31.8,
        "cost_volume 720p ms": 2.372,
        "sgm_path_sweep x7 720p ms": 5.329,
        "sgm_path_sweep 720p (1,0) ms": 1.5,
        "sgm_sweep_wta 720p 8-dir ms": 1.222,
        "config 2 s/pair": 0.0096,
        "config 3 s/pair": 0.0861,
        "4K cost_volume ms": 27.6,
        "4K sgm_path_sweep x4 ms": 38.65,
        "kernels line cost_volume ms": 2.37,
    }


@pytest.mark.parametrize("drop", ["nvidia-smi: ", "[720p 8-dir] sgm_path_sweep x7"])
def test_parse_falls_back_or_omits(drop):
    """A log cut at its head still names the card (the line before the last),
    and a missing line leaves its key out."""
    log = "\n".join(line for line in LOG.splitlines() if not line.startswith(drop))
    got = CS.parse(log)
    assert got["card"] == "NVIDIA H100 80GB HBM3, 700.00 W"
    assert ("sgm_path_sweep x7 720p ms" in got) == (drop == "nvidia-smi: ")


def test_main_refuses_a_tree_without_chip_smoke(tmp_path, capsys):
    assert CS.main([str(tmp_path), "--out", str(tmp_path / "out")]) == 2
    assert "no chip_smoke.py" in capsys.readouterr().out


def test_parse_reads_fused_candidates_and_speckle_lines():
    log = "\n".join([
        '[720p 720x1152x128 8-dir] fused direction candidates, equal maps (FUSED_DIR -1,0): '
        '{"-1,0": {"sweeps_ms": 1.7, "sweep_wta_ms": 0.4, "sum_ms": 2.1}, '
        '"0,1": {"sweeps_ms": 1.6, "sweep_wta_ms": 0.45, "sum_ms": 2.05}}',
        "[720p frame (720, 1152)] speckle_labels: equal to the plain fixpoint; kernel 0.031 ms, "
        "plain 20.5 ms; 829440 valid pixels in 12 components",
        "[720p frame] speckle_keep: equal for T in [20, 100]; kernel 0.013 ms, plain 0.5 ms; "
        "keep share at T=100 0.9",
        '[720p frame] speckle_labels launches (ms, profiler): {"labels_local_kernel": 0.02, '
        '"labels_flatten_kernel": 0.008}',
    ])
    got = CS.parse(log)
    assert got == {
        "fused 720p (-1,0) sweeps ms": 1.7, "fused 720p (-1,0) sweep_wta ms": 0.4,
        "fused 720p (-1,0) sum ms": 2.1, "fused 720p (0,1) sweeps ms": 1.6,
        "fused 720p (0,1) sweep_wta ms": 0.45, "fused 720p (0,1) sum ms": 2.05,
        "speckle_labels 720p frame ms": 0.031, "speckle_keep 720p frame ms": 0.013,
        "speckle_labels 720p frame labels_local_kernel ms": 0.02,
        "speckle_labels 720p frame labels_flatten_kernel ms": 0.008,
    }


def test_parse_reads_lr_busy_idle_and_peak_lines():
    log = "\n".join([
        "[720p 8-dir] lr_check: equal; kernel 0.010 ms, plain 10.5 ms; keep share 0.97",
        "[720p 5-dir] lr_check: equal; kernel 0.011 ms, plain 10.4 ms; keep share 0.97",
        "profile 720p sgbm_disparity x128 8-dir (device speckle): wall 4.787 ms, device busy "
        "2.606 ms, idle share 0.4556",
        "profile 4K device chain x256 5-dir (config 3, device speckle): wall 40.158 ms, device "
        "busy 34.179 ms, idle share 0.1489",
        "4K device chain 3840x2160 x256 5-dir: s/pair first (cold) 0.036, warm [0.0357] "
        "(warm median 0.0357 s, 232.4 MPix/s); masked point sum 1.0; peak 7.850 GiB; kept "
        "non-margin share 0.99",
    ])
    assert CS.parse(log) == {
        "lr_check 720p 8-dir ms": 0.010, "lr_check 720p 5-dir ms": 0.011,
        "config 2 device busy ms": 2.606, "config 2 idle share": 0.4556,
        "config 3 device busy ms": 34.179, "config 3 idle share": 0.1489,
        "config 3 s/pair": 0.0357, "config 3 peak GiB": 7.850,
    }


def test_parse_reads_the_s_volume_route_and_op_chain_lines():
    log = "\n".join([
        "[720p 8-dir] sgm_sweep_sum: equal; kernel 0.512 ms, plain 130.1 ms; bound 0.3171 ms "
        "(bytes), share 0.6193",
        "[720p 8-dir] sgm_aggregate (S volume): equal; wta_maps(S) == sgm_wta; kernels 2.401 ms, "
        "plain 1250.2 ms; bound 0.1902 ms (bytes), share 0.0792; route bytes bound 1.5213 ms, "
        'share 0.6336; peak 0.7910 GiB allocated by the call (C 0.1978 GiB); launches '
        '{"sgm_path_sweep": 7, "sgm_sweep_sum": 1}',
        "[720p 5-dir] sgm_aggregate (S volume): equal; wta_maps(S) == sgm_wta; kernels 4.429 ms, "
        "plain 1237.0 ms; bound 0.1902 ms (bytes), share 0.0429",
        "[op_chain (1024, 512) torch.int16 add+min] equal; kernel 6.10 us (graph replay); "
        "back-to-back eager calls 30.00 us; plain 2.800 ms",
        "[op_chain (16384, 512) torch.float32 roll+add+min] equal; kernel 80.50 us (graph replay)",
        'op_chain SASS, add+min at W = 512: {"int16": {"min_instructions": 768, '
        '"registers_a_lane": 8, "opcodes": {"VIADDMNMX.S16x2": 768}}}',
    ])
    assert CS.parse(log) == {
        "sgm_sweep_sum 720p 8-dir ms": 0.512, "sgm_aggregate 720p 8-dir ms": 2.401,
        "sgm_aggregate 720p 8-dir peak GiB": 0.7910, "sgm_aggregate 720p 5-dir ms": 4.429,
        "op_chain 1024x512 int16 add+min us": 6.10,
        "op_chain 16384x512 float32 roll+add+min us": 80.50,
        "op_chain SASS int16 mins": 768,
    }
    # The parent's SASS line: a count per mangled kernel name.
    old = 'op_chain SASS, add+min at W = 512: min instructions {"_Z4kernIsLi16ELi6EE": 1536}'
    assert CS.parse(old) == {"op_chain SASS _Z4kernIsLi16ELi6EE mins": 1536}


PTXAS_LOG = """$ nvcc -c -o a.o sgm.cu
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_116sweep_wta_kernelILi4ELb1ELb1EEEvPKsPKtS4_PfPhPiS7_iiiiiiiiiii' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_116sweep_wta_kernelILi4ELb1ELb1EEEvPKsPKtS4_PfPhPiS7_iiiiiiiiiii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 96 registers, 24576 bytes smem, 452 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_116sweep_sum_kernelILi8ELb0ELi2EEEvPKsPKtS4_Piiiiiiiiiii' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_116sweep_sum_kernelILi8ELb0ELi2EEEvPKsPKtS4_Piiiiiiiiiii
    8 bytes stack frame, 4 bytes spill stores, 8 bytes spill loads
ptxas info    : Used 128 registers, 16 bytes smem, 420 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_117path_sweep_kernelILi4ELb1EEEvPKsPtiiiiiiiii' for 'sm_90a'
ptxas info    : Used 64 registers, 400 bytes cmem[0]
$ nvcc -shared -o lib.so a.o
"""


def test_ptxas_reads_the_fused_sweep_instances_of_the_newest_build(tmp_path):
    (tmp_path / "build").mkdir()
    (tmp_path / "build" / "libsrcv_kernels-0.log").write_text("no report")
    newest = tmp_path / "build" / "libsrcv_kernels-1.log"
    newest.write_text(PTXAS_LOG)
    os.utime(newest, (2e9, 2e9))
    assert CS.ptxas(tmp_path) == {
        "ptxas sweep_wta_kernel<4,1,1> registers": 96,
        "ptxas sweep_wta_kernel<4,1,1> spill bytes": 0,
        "ptxas sweep_sum_kernel<8,0,2> registers": 128,
        "ptxas sweep_sum_kernel<8,0,2> spill bytes": 12,
    }
    assert CS.ptxas(tmp_path / "nothing built") == {}


@pytest.mark.parametrize("entry,short", [
    ("_ZN38_GLOBAL__N__2ae61b97_6_sgm_cu_9d433ce516sweep_wta_kernelILi4ELb1ELb1EEEvPKsPKtS4_PfPhPiS7_"
     "iiiiiiiiiii", "sweep_wta_kernel<4,1,1>"),
    ("_ZN38_GLOBAL__N__2ae61b97_6_sgm_cu_9d433ce516sweep_sum_kernelILi16ELb0ELi2EEEvPKsPKtS4_Piiiii",
     "sweep_sum_kernel<16,0,2>"),
    ("_ZN44_GLOBAL__N__3942167b_11_op_chain_cu_30eaf52b15op_chain_kernelIsLi16ELi6EEEvPKT_PS1_iS1_",
     "op_chain_kernel<16,6>"),
    ("_Z6kernelPf", "_Z6kernelPf"),
    ("_ZN12_GLOBAL__N_15plainEv", "_ZN12_GLOBAL__N_15plainEv"),
])
def test_kernel_instance_names_template_instances(entry, short):
    """The build's namespaces carry a hash of the source; the short name
    does not, so two checkouts' instances line up."""
    from stereo_reconstruction_cv_tpu_torch import _build

    assert _build.kernel_instance(entry) == short

"""The learned feature net (XFeat-style) and its weights file."""

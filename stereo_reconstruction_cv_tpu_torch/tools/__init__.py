"""Probes that time one kernel at a time on the card (``python -m ...tools.<name>``)."""

"""Command-line tools over the port (counterparts of ``extra/``)."""

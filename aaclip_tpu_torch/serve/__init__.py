"""The serving engine and its HTTP server (``serve/server.py``)."""

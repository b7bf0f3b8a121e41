"""The agent tier of the port (``consul_tpu/agent``): so far the HTTP
blocking-query parameters (``http.py``) the async front end shares."""

"""The HTTP/WS server of the port (port of ``apex_studio_tpu/server``)."""

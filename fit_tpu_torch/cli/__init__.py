"""Entry points of the port: the HTTP front end of the sampling server."""

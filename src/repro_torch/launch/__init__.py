"""Entry points of the port: ``serve``, the serving launcher."""

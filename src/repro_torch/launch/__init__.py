"""Entry points of the port: ``serve``, the serving launcher, and
``train``, the training launcher."""

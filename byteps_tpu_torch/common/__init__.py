"""Logging, configuration and metrics of the port (own copies; the
port imports nothing of ``byteps_tpu``)."""

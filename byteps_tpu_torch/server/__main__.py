"""``python -m byteps_tpu_torch.server``: serve one summation server of the
DCN tier until every worker shut down. Configured by the environment as
the reference's server role: ``DMLC_NUM_WORKER``, ``DMLC_PS_ROOT_URI``,
``DMLC_PS_ROOT_PORT`` (server i listens on that port + 1 + i),
``DMLC_SERVER_ID``."""

from byteps_tpu_torch.server import serve_forever

if __name__ == "__main__":
    serve_forever()

"""Server-role entry of the distributed kvstore.

Counterpart of ``mxnet_tpu/kvstore_server.py`` (parity: reference
``python/mxnet/kvstore_server.py``). In the reference a ``DMLC_ROLE=server``
process enters ``KVStoreServer.run()`` and serves ps-lite push/pull
until told to stop. Here, as in the JAX package, every worker runs the
same program and the gradients are all-reduced, so there is no server
to host; the entry point stays so launch scripts that start
worker/server/scheduler triples keep working:

* ``DMLC_ROLE=worker`` or unset: nothing happens;
* ``DMLC_ROLE=server`` or ``scheduler``: the role is logged as absorbed
  by the collectives and the process exits 0 at import, before any
  training code runs.

A command sent with ``send_command_to_servers`` (an optimizer blob) is
decoded for the log only.
"""
from __future__ import annotations

import logging
import os
import pickle

from . import kvstore

__all__ = ["KVStoreServer", "_init_kvstore_server_module"]


class KVStoreServer:
    """The shell of the reference's server run-loop."""

    def __init__(self, kv):
        self.kvstore = kv
        self.handle = getattr(kv, "handle", None)
        self.init_logging = False

    def _controller(self):
        """The server controller (parity: kvstore_server.py:41)."""
        def server_controller(cmd_id, cmd_body, _):
            if not self.init_logging:
                header = "%(asctime)-15s Server[" + str(
                    self.kvstore.rank) + "]"
                logging.basicConfig(level=logging.DEBUG, format=header)
                self.init_logging = True
            if cmd_id == 0:
                try:
                    optimizer = pickle.loads(
                        cmd_body if isinstance(cmd_body, bytes)
                        else cmd_body.encode("latin1"))
                except Exception:  # diagnostics only
                    optimizer = cmd_body
                logging.info("server optimizer (applied by every worker "
                             "after the all-reduce): %s", optimizer)
            else:
                logging.info("server command %d ignored: no server "
                             "process exists", cmd_id)
        return server_controller

    def run(self):
        """Log that the role is absorbed and return: there are no RPCs
        to wait for."""
        logging.info("kvstore server role absorbed by the workers' "
                     "all-reduce; nothing to serve, exiting the run loop")


def _init_kvstore_server_module():
    """Run the server shell and exit when this process was launched with
    a server or scheduler role (parity: kvstore_server.py:75, run at
    import)."""
    role = os.environ.get("DMLC_ROLE", "worker").lower()
    if role in ("server", "scheduler"):
        server = KVStoreServer(kvstore.create("dist"))
        server.run()
        raise SystemExit(0)


_init_kvstore_server_module()

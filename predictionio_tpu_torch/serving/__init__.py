"""Multi-process serving tier: SO_REUSEPORT HTTP frontends + shm rings.

The query-serving ceiling on a small box is the GIL-serialized python of
the HTTP stack itself (~2.5 ms/request -> ~400 qps at 32 clients on the
2-core box), not the models. This package splits serving into N frontend
WORKER PROCESSES -- each binds its own ``SO_REUSEPORT`` listener and runs
an accept/parse/validate loop -- feeding one device-owning SCORER process
(the existing :class:`~predictionio_tpu_torch.workflow.create_server.QueryService`
with its ``MicroBatcher`` unchanged) through per-worker shared-memory
message rings. "Add a core" becomes "add a frontend worker".

This ``__init__`` must stay import-light: the frontend worker entry point
(``python -m predictionio_tpu_torch.serving.frontend``) runs in a fresh
interpreter per worker and must come up in well under a second -- no torch,
no storage, no engine imports (``predictionio_tpu_torch.workflow`` pulls in all
three).

Port copy: ``predictionio_tpu/serving/__init__.py`` (framework-free), verbatim,
under the port's package name; ``tests/test_torch_imports.py`` holds it
to the original.
"""

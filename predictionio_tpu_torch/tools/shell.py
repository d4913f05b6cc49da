"""``pio shell``: interactive console with the runtime preloaded.

Port of ``predictionio_tpu/tools/shell.py``: IPython (or
``code.interact``) with the storage registry, the event stores,
``load_engine_variant`` and ``pypio`` bound.

Departure: the reference preloads ``RuntimeContext``
(``predictionio_tpu/workflow/context.py``), which holds its workflow
params and its JAX mesh. The port has no ``RuntimeContext``: its
counterparts are preloaded instead, ``WorkflowParams``
(``workflow/core_workflow.py``) and ``TrainContext``
(``controller/base.py``: the device, the mesh shape and the runtime
conf a training call runs under).
"""

from __future__ import annotations


def run_shell() -> int:
    from predictionio_tpu_torch import pypio
    from predictionio_tpu_torch.controller.base import TrainContext
    from predictionio_tpu_torch.data import storage
    from predictionio_tpu_torch.data.store import LEventStore, PEventStore
    from predictionio_tpu_torch.workflow.core_workflow import WorkflowParams
    from predictionio_tpu_torch.workflow.json_extractor import load_engine_variant

    namespace = {
        "storage": storage,
        "LEventStore": LEventStore,
        "PEventStore": PEventStore,
        "WorkflowParams": WorkflowParams,
        "TrainContext": TrainContext,
        "load_engine_variant": load_engine_variant,
        "pypio": pypio,
    }
    banner = (
        "predictionio_tpu_torch shell -- preloaded: storage, LEventStore, PEventStore,\n"
        "WorkflowParams, TrainContext, load_engine_variant, pypio"
        " (init/find_events/save_model)"
    )
    print(banner)
    try:
        from IPython import start_ipython

        start_ipython(argv=["--no-banner"], user_ns=namespace)
    except ImportError:
        import code

        code.interact(banner="", local=namespace)
    return 0

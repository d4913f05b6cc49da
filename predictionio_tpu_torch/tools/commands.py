"""Registration point for the port's ``pio`` verbs.

Copy of ``predictionio_tpu/tools/commands.py``: each verb module of the
port registers its verbs here, one module for each of the reference's.
The reference's ``check`` (its ``analysis/`` package) is not ported yet.
"""

from __future__ import annotations

import argparse


def register(sub: argparse._SubParsersAction) -> None:
    from predictionio_tpu_torch.tools import (
        app_commands,
        build_commands,
        daemon_commands,
        engine_commands,
        import_export,
        server_commands,
        top_command,
    )

    app_commands.register(sub)
    build_commands.register(sub)
    daemon_commands.register(sub)
    engine_commands.register(sub)
    import_export.register(sub)
    server_commands.register(sub)
    top_command.register(sub)

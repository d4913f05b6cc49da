"""Launch counts of the hand-written kernels, by wrapper name.

Each kernel's wrapper is decorated with ``counted``, which starts its
``launches`` at 0 and registers it in ``KERNELS``; the wrapper adds one
to ``launches`` where it launches its kernel, and nowhere else.
``chip_smoke.py`` resets and reads the counts, and a query server's
``/metrics`` reports every registered wrapper's count as
``pio_kernel_launches_total{kernel="<name>"}``
(``workflow/create_server.py``), which is how a deployed or shard
process's launches are read from outside it. A wrapper registers when
its module is imported, so a process that never imported a kernel's
module reports no count for it.
"""

from __future__ import annotations

from typing import Callable

#: the registered wrappers, by name
KERNELS: dict[str, Callable] = {}


def counted(wrapper: Callable) -> Callable:
    """Register ``wrapper`` with ``launches`` = 0."""
    wrapper.launches = 0
    KERNELS[wrapper.__name__] = wrapper
    return wrapper

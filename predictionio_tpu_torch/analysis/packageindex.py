"""The shared whole-package analysis state: one build, every rule reads.

Port of ``predictionio_tpu/analysis/packageindex.py`` without its
``meshflow()`` accessor: the reference's S family and ``--mesh-report``
read that layer, and the port carries neither.

``PackageIndex`` bundles the three phase-2 layers -- call graph
(``callgraph``), thread roles (``threadroles``), lockset model
(``locksets``) -- built ONCE per ``pio check`` run over every parsed
module and handed to each package-level rule. Rules must not rebuild any
layer themselves: the sweep's time budget (<10 s on the 2-core box)
is paid for by sharing this index.

``PackageRule`` is the base for rules that need cross-module context;
its ``check(ctx)`` convenience wraps a single module in a one-file index
so rule fixtures (``tests/test_torch_analysis.py``) keep the same entry point
as per-module rules.
"""

from __future__ import annotations

from dataclasses import dataclass

from predictionio_tpu_torch.analysis.callgraph import CallGraph
from predictionio_tpu_torch.analysis.locksets import LockModel
from predictionio_tpu_torch.analysis.threadroles import RoleInference


@dataclass
class PackageIndex:
    contexts: list
    graph: CallGraph
    roles: RoleInference
    locks: LockModel
    #: lazily-built phase-3 layer (exception-edge resource dataflow);
    #: C-only runs never pay for it
    _resources: object = None
    #: lazily-built cross-process protocol layer; non-P runs never pay
    #: for it
    _protocols: object = None

    #: single-entry memo: (context identity tuple, pinned context list,
    #: index). ``parse_module`` returns the SAME ModuleContext object for
    #: an unchanged file, so an identical identity tuple proves the trees
    #: are identical and the previous build (plus its lazy layers) can be
    #: reused -- the check+report flows and the fixture suite build the
    #: same index back to back. The pinned list keeps the contexts alive
    #: so their ids cannot be recycled while the memo holds them.
    _build_memo = None

    @classmethod
    def build(cls, contexts: list) -> "PackageIndex":
        contexts = list(contexts)
        key = tuple(map(id, contexts))
        memo = cls._build_memo
        if memo is not None and memo[0] == key:
            return memo[2]
        graph = CallGraph(contexts)
        index = cls(
            contexts=contexts,
            graph=graph,
            roles=RoleInference(graph),
            locks=LockModel(graph),
        )
        cls._build_memo = (key, contexts, index)
        return index

    def resources(self):
        """The shared :class:`~predictionio_tpu_torch.analysis.flowgraph.
        ResourceFlow`: per-function flowgraphs + obligation summaries,
        built ONCE per index and cached alongside it (every R rule
        reads the same build)."""
        if self._resources is None:
            from predictionio_tpu_torch.analysis.flowgraph import ResourceFlow

            self._resources = ResourceFlow(self)
        return self._resources

    def protocols(self):
        """The shared :class:`~predictionio_tpu_torch.analysis.protocols.
        ProtocolFlow`: declared commit/publish/advance points classified
        over the call graph + process roles, built ONCE per index and
        cached (every P rule and ``--protocol-report`` read the same
        build)."""
        if self._protocols is None:
            from predictionio_tpu_torch.analysis.protocols import ProtocolFlow

            self._protocols = ProtocolFlow(self)
        return self._protocols


class PackageRule:
    """Base for rules whose ``check_package(index)`` needs the whole
    program; ``check(ctx)`` adapts a single module for fixtures."""

    def check(self, ctx):
        yield from self.check_package(PackageIndex.build([ctx]))

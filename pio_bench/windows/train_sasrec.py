"""Window entry ``train_sasrec``: one ``models/sequence/model.py::
train_sasrec`` call of the configuration over the events grouped per
user, whole epochs sized to fill the run, the model seeded by the run's
``--seed`` (its init and each epoch's permutation).

Set-up draws the events, groups them (``group_sequences``) and pads them
(``SequencePreparator``) as the template's DataSource and Preparator do,
then runs two short warm calls on the first rows, the second ending in a
batch as short as an epoch's last and timed step by step, and from its
median step sets ``epochs``. The window is the one call, every step's loss kept
(``log_every=1``, read once at the end).

The call builds its model and Adam state inside, so the check watches
that one optimizer through ``torch.optim``'s global step hooks: the
parameters before step 1, the gradient Adam got at step 1 and the
parameters after step 3. What decides ``correct``:

- ``init``: the call's parameters before step 1 against the reference's
  seeded init, entry by entry (exact);
- ``loss.1`` .. ``loss.3``: the call's first three step losses against the
  reference's three Adam steps on the same first three batches, relative;
- ``grad.median``: the median leaf's gap between the norms of the first
  gradient;
- ``change.median``: the median leaf's gap between the norms of the
  parameters' change over the three steps, leaves whose reference
  gradient is under a thousandth of the median leaf's left out (they move
  by round-off).

The median leaf, not the worst: on a few seeds in ten a ReLU whose input
lies within rounding of zero passes its gradient on one side and not on
the other, and the small leaf that feeds on it (a LayerNorm's scale or
bias) reads a hundred times the others; the plain reference in float32
does so on other seeds than the program. The worst leaf and its gap are
still in the run's facts;
- ``b4.missing``, ``bwd.missing``: B4 and fused-backward launches the
  window lacks of one per block and step.
"""

from __future__ import annotations

import dataclasses
import math
import statistics
import time
from dataclasses import dataclass, field

import numpy as np

from pio_bench import bounds, generator
from pio_bench.checks import Check, exact_gap, leaf_norm_gaps, relative_gap

WATCHED_STEPS = 3
#: a leaf whose reference first gradient is under this share of the
#: median leaf's moves under Adam by round-off alone
STILL_LEAF = 1e-3


@dataclass
class State:
    ratings: generator.Ratings | None = None
    matrix: np.ndarray | None = None
    config: object = None
    epochs: int = 0
    lengths: np.ndarray | None = None
    watch: object = None
    names: list = field(default_factory=list)
    losses: list = field(default_factory=list)
    launches: dict = field(default_factory=dict)


class StepWatch:
    """Global ``torch.optim`` step hooks over the window's one call."""

    def __init__(self, step):
        self.step = step
        self.count = 0
        self.before: list | None = None
        self.grad: list | None = None
        self.after: list | None = None
        self.handles = []

    @staticmethod
    def _params(optimizer) -> list:
        return [p for group in optimizer.param_groups for p in group["params"]]

    def _pre(self, optimizer, args, kwargs) -> None:
        if self.count == 0:
            self.before = [p.detach().clone() for p in self._params(optimizer)]

    def _post(self, optimizer, args, kwargs) -> None:
        self.count += 1
        if self.count == 1:
            self.grad = [p.grad.detach().clone() for p in self._params(optimizer)]
        if self.count == WATCHED_STEPS:
            self.after = [p.detach().clone() for p in self._params(optimizer)]
        self.step()

    def __enter__(self) -> "StepWatch":
        from torch.optim.optimizer import (
            register_optimizer_step_post_hook,
            register_optimizer_step_pre_hook,
        )

        self.handles = [register_optimizer_step_pre_hook(self._pre),
                        register_optimizer_step_post_hook(self._post)]
        return self

    def __exit__(self, *exc) -> None:
        for handle in self.handles:
            handle.remove()


def _sasrec_config(run, epochs: int):
    from predictionio_tpu_torch.models.sequence.model import SASRecConfig

    cfg = run.config
    algo, data = cfg["algorithm"], cfg["data"]
    return SASRecConfig(
        num_items=int(data["items"]), max_len=int(cfg["preparator"]["maxLen"]),
        embed_dim=int(algo["embedDim"]), num_heads=int(algo["numHeads"]),
        num_blocks=int(algo["numBlocks"]), ffn_dim=int(algo["ffnDim"]),
        dropout=float(algo.get("dropout", 0.0)), learning_rate=float(algo["learningRate"]),
        batch_size=int(algo["batchSize"]), epochs=epochs, seed=run.seed,
        seq_parallel=algo.get("seqParallel", "ring"), attention="auto")


def setup(run) -> State:
    from predictionio_tpu_torch.models.sequence.engine import (
        SequencePreparator,
        SequencesData,
        group_sequences,
    )
    from predictionio_tpu_torch.models.sequence.model import train_sasrec

    cfg, params = run.config, run.cell["params"]
    data = cfg["data"]
    state = State()
    ev = state.ratings = generator.ratings(run.traffic, data["users"], data["items"],
                                           data["events"], run.seed)
    min_len = int(cfg["datasource"]["minSeqLen"])
    t0 = time.perf_counter()
    sequences, user_ids = group_sequences(
        ev.users, ev.items, ev.times, [f"u{u}" for u in range(ev.num_users)], min_len)
    packed = SequencePreparator(dict(cfg["preparator"])).prepare(
        None, SequencesData(sequences, user_ids, [f"i{i}" for i in range(ev.num_items)]))
    state.matrix = packed.matrix
    run.spans["sasrec.pack_s"] = time.perf_counter() - t0
    config = _sasrec_config(run, 1)
    n, b = state.matrix.shape[0], config.batch_size
    tail = n % b
    train_sasrec(config, state.matrix[: b * int(params["warm_steps"])], run.device)
    # the timed warm call's steps, by the host's clock at each Adam step:
    # the later half, once the card's queue is full, paces an epoch
    ticks: list[float] = []
    with StepWatch(lambda: ticks.append(time.perf_counter())):
        train_sasrec(config, state.matrix[: b * int(params["timed_warm_steps"]) + tail],
                     run.device)
    per_step = statistics.median(np.diff(ticks[len(ticks) // 2:]))
    steps_per_epoch = math.ceil(n / b)
    state.epochs = max(1, round(run.seconds / (per_step * steps_per_epoch)))
    state.config = dataclasses.replace(config, epochs=state.epochs)

    # the yardstick's own lengths: each kept user's events, capped
    counts = np.bincount(ev.users, minlength=ev.num_users)
    state.lengths = np.minimum(counts[counts >= min_len], config.max_len)
    run.facts["steps"] = state.epochs * steps_per_epoch
    return state


def _step_rows(state: State, steps) -> dict[int, np.ndarray]:
    """The rows of each given 1-based step: each epoch's permutation of
    ``numpy``'s generator of the configuration's seed, cut in batches."""
    cfg = state.config
    n = state.matrix.shape[0]
    per_epoch = math.ceil(n / cfg.batch_size)
    wanted = sorted(steps)
    rng = np.random.default_rng(cfg.seed)
    out, epoch, order = {}, -1, None
    for s in wanted:
        e, j = divmod(s - 1, per_epoch)
        while epoch < e:
            order, epoch = rng.permutation(n), epoch + 1
        out[s] = order[j * cfg.batch_size:(j + 1) * cfg.batch_size]
    return out


def window(run, state: State) -> None:
    from predictionio_tpu_torch.models.sequence.model import train_sasrec
    from predictionio_tpu_torch.ops import flash_attention

    if run.tracer is not None:
        first = run.tracer.first_step()
        traced = range(first, first + run.tracer.active)
        cfg = state.config
        rows = _step_rows(state, traced)
        bound = flops = 0.0
        h, t = cfg.num_heads, cfg.max_len
        d = cfg.embed_dim // h
        for s in traced:
            b = len(rows[s])
            pairs = bounds.causal_pairs(state.lengths[rows[s]], t)
            bound += cfg.num_blocks * (bounds.flash_bound("flash_forward", b, h, t, d, pairs)
                                       + bounds.flash_bound("flash_backward", b, h, t, d, pairs))
            flops += bounds.sasrec_step_flops(b, t, cfg.embed_dim, cfg.ffn_dim, cfg.num_blocks,
                                              cfg.num_items + 1, pairs)
        run.facts.update({"attn_bound_s": bound, "step_flops": flops,
                          "attn_launches": 2 * cfg.num_blocks * len(traced)})
    counts = {k: getattr(flash_attention, k).launches for k in ("flash_forward",
                                                                "flash_backward")}
    step = run.tracer.step if run.tracer is not None else (lambda: None)
    with StepWatch(step) as watch:
        params, losses = train_sasrec(state.config, state.matrix, run.device, log_every=1)
    state.watch, state.losses, state.names = watch, losses, list(params)
    state.launches = {k: getattr(flash_attention, k).launches - v for k, v in counts.items()}


def outcome(run, state: State, wall_s: float) -> tuple[dict, int, int]:
    """``(end-to-end metrics, steps attempted, steps failed)``: a step
    whose loss is not finite failed."""
    samples = state.epochs * state.matrix.shape[0]
    failed = sum(1 for x in state.losses if not math.isfinite(x))
    return {"train_samples_per_s": samples / wall_s}, len(state.losses), failed


def release(run, state: State) -> None:
    import torch

    watch = state.watch
    for name in ("before", "grad", "after"):
        leaves = getattr(watch, name)
        if leaves is not None:
            setattr(watch, name, [x.cpu() for x in leaves])
    if run.device == "cuda":
        torch.cuda.empty_cache()


def checks(run, state: State, control: bool = False) -> list[Check]:
    import torch

    ref, cfg, ev = run.reference, state.config, state.ratings
    limits = run.cell["limits"]
    device = "cuda" if run.device == "cuda" else "cpu"
    watch = state.watch
    # one launch of each per block and step; the plain attention of a
    # CPU run launches nothing
    expected = cfg.num_blocks * len(state.losses) if run.device == "cuda" else 0
    out = [Check(f"{short}.missing", float(max(expected - state.launches[kernel], 0)),
                 limits[f"{short}.missing"])
           for short, kernel in (("b4", "flash_forward"), ("bwd", "flash_backward"))]
    if watch.after is None or len(watch.before) != len(state.names):
        return out + [Check("watched", math.inf, 0.0)]
    init = ref.initial_params(cfg.num_items + 1, cfg.max_len, cfg.embed_dim, cfg.num_blocks,
                              cfg.ffn_dim, cfg.seed)
    got_init = dict(zip(state.names, watch.before))
    seqs = ref.sequences(ev.users, ev.items, ev.times, cfg.max_len,
                         int(run.config["datasource"]["minSeqLen"]), device)
    batches = [seqs[torch.as_tensor(rows, device=device)]
               for rows in ref.first_batches(seqs.shape[0], cfg.batch_size, WATCHED_STEPS,
                                             cfg.seed)]

    def numbers(losses, grad, after, base) -> dict:
        norms = sorted(float(g.double().norm()) for g in grad.values())
        floor = STILL_LEAF * norms[len(norms) // 2]
        moving = [n for n, g in grad.items() if float(g.double().norm()) >= floor]
        change = {n: after[n].double().cpu() - base[n].double().cpu() for n in moving}
        return {"losses": losses, "grad": grad, "change": change, "moving": moving}

    judged = numbers(*ref.train(init, batches, cfg.num_heads, cfg.num_blocks,
                                cfg.learning_rate, "f64", device)[:3], init)

    def compare(prefix: str, losses, grad, change) -> list[Check]:
        got = [Check(f"{prefix}loss.{i + 1}", relative_gap(losses[i], judged["losses"][i]),
                     limits[f"loss.{i + 1}"]) for i in range(WATCHED_STEPS)]
        got.append(Check(f"{prefix}grad.median",
                         statistics.median(leaf_norm_gaps(grad, judged["grad"]).values()),
                         limits["grad.median"]))
        gaps = leaf_norm_gaps(change, judged["change"], judged["moving"])
        got.append(Check(f"{prefix}change.median", statistics.median(gaps.values()),
                         limits["change.median"]))
        return got

    program_change = {n: a.double() - b.double() for n, a, b in
                      zip(state.names, watch.after, watch.before)}
    # which leaf each worst gap is, for the record beside the numbers
    for name, got, want, leaves in (
            ("grad", dict(zip(state.names, watch.grad)), judged["grad"], None),
            ("change", program_change, judged["change"], judged["moving"])):
        gaps = leaf_norm_gaps(got, want, leaves)
        worst = max(gaps, key=gaps.get)
        run.facts[f"{name}.worst_leaf"] = [worst, gaps[worst]]
    out.append(Check("init", exact_gap(got_init, init), limits["init"]))
    out += compare("", state.losses[:WATCHED_STEPS], dict(zip(state.names, watch.grad)),
                   program_change)
    if control:
        low = ref.train(init, batches, cfg.num_heads, cfg.num_blocks, cfg.learning_rate,
                        "tf32", device)
        low_change = {n: low[2][n].double().cpu() - init[n].double() for n in low[2]}
        out += compare("control.", low[0], low[1], low_change)
    return out


def faults() -> dict:
    """Faults planted in the program, by name, each a context manager:
    the test that ``correct`` comes out false for each."""
    import contextlib

    import torch

    from predictionio_tpu_torch.models.sequence import model

    @contextlib.contextmanager
    def swap(obj, name, value):
        original = getattr(obj, name)
        setattr(obj, name, value)
        try:
            yield
        finally:
            setattr(obj, name, original)

    original_loss = model.sequence_loss

    def half_batch_loss(net, seq, target):
        keep = max(seq.shape[0] // 2, 1)
        return original_loss(net, seq[:keep], target[:keep])

    @contextlib.contextmanager
    def unchanged():
        with swap(torch.optim.Adam, "step", lambda self, closure=None: None):
            yield

    return {
        "state_unchanged": unchanged,
        "half_batch": lambda: swap(model, "sequence_loss", half_batch_loss),
    }

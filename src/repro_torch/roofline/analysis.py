"""Roofline terms and model FLOPs (port of ``repro/roofline/analysis.py``).

Three terms per step, in SECONDS (per step, per device):

    compute    = FLOPs       / peak_FLOP/s
    memory     = HBM bytes   / HBM bandwidth
    collective = coll bytes  / interconnect bandwidth per link

drawn against a :class:`Machine` profile.  The card's profile is NVIDIA's
H100 SXM5 datasheet (dense bf16 tensor rate, HBM3 bandwidth, NVLink 4).

:func:`collective_bytes` counts the collectives a step placed over a
mesh issues on this process (DTensor's redistributions, the functional
collectives of ``torch.ops._c10d_functional``, and the raw
``torch.distributed`` calls, ``torch.ops.c10d``), by the reference's
kinds and its definition of their bytes: each collective's OUTPUT bytes
on one device.  There is no HLO to parse, so its counterpart's
``parse_hlo_computations`` is not ported, and no loop trip count is
needed: an eager step issues every collective of every trip.
"""
from __future__ import annotations

import dataclasses
import os

import torch
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

#: Env knob selecting the machine profile by name (``MACHINES`` keys).
MACHINE_ENV = "REPRO_MACHINE"


@dataclasses.dataclass(frozen=True)
class Machine:
    """Per-device peak rates a roofline is drawn against.

    ``cpu-interpret`` is the reference's deliberately coarse host profile
    (one server core's DRAM stream + vector peak, order of magnitude only):
    CPU runs report a fraction against a ceiling of the right power of ten,
    never a device metric."""

    name: str
    peak_flops: float        # FLOP/s
    hbm_bw: float            # bytes/s (main-memory stream bandwidth)
    link_bw: float           # bytes/s per link and direction (0 = none)


MACHINES: dict[str, Machine] = {
    # NVIDIA H100 SXM5 datasheet, at its full 700 W: 989 TFLOP/s dense
    # bf16, 3.35 TB/s HBM3.  NVLink 4 is 18 links, 900 GB/s both ways
    # together: 25 GB/s per link and direction.  No one-card path has a
    # collective term.
    "h100-sxm": Machine("h100-sxm", 989e12, 3.35e12, 25e9),
    "cpu-interpret": Machine("cpu-interpret", 5e10, 2e10, 1e10),
}

#: ``torch.cuda.get_device_name()`` of the H100 SXM5 part.
H100_SXM_NAMES = ("NVIDIA H100 80GB HBM3",)


def current_machine() -> Machine:
    """Active machine profile: ``REPRO_MACHINE`` if set (ValueError on an
    unknown name), else ``h100-sxm`` for a visible H100 SXM card and
    ``cpu-interpret`` without a card.  Any other card raises: its rates
    are not the H100's, so ``REPRO_MACHINE`` must name a profile."""
    name = os.environ.get(MACHINE_ENV)
    if name is not None:
        if name not in MACHINES:
            raise ValueError(
                f"{MACHINE_ENV}={name!r} is not a known machine profile; "
                f"valid values: {sorted(MACHINES)}")
        return MACHINES[name]
    if not torch.cuda.is_available():
        return MACHINES["cpu-interpret"]
    card = torch.cuda.get_device_name()
    if card in H100_SXM_NAMES or "H100 SXM" in card:
        return MACHINES["h100-sxm"]
    raise RuntimeError(
        f"no machine profile for the card {card!r}; set {MACHINE_ENV} to "
        f"one of {sorted(MACHINES)} if its rates apply")


#: The reference's collective kinds (XLA's op names).
COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

#: The functional (``_c10d_functional``) and raw (``c10d``) collectives
#: by the reference's kinds.  XLA has no broadcast: the one-to-all copy a
#: launcher sends from process 0 is counted with the point-to-point
#: sends, ``collective-permute``.
_KIND = {"all_reduce": "all-reduce", "all_reduce_": "all-reduce",
         "all_reduce_coalesced": "all-reduce",
         "all_reduce_coalesced_": "all-reduce",
         "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
         "all_gather_into_tensor": "all-gather",
         "all_gather_into_tensor_out": "all-gather",
         "all_gather_into_tensor_coalesced": "all-gather",
         "allgather_": "all-gather", "_allgather_base_": "all-gather",
         "allgather_into_tensor_coalesced_": "all-gather",
         "reduce_scatter_tensor": "reduce-scatter",
         "reduce_scatter_tensor_coalesced": "reduce-scatter",
         "reduce_scatter_": "reduce-scatter",
         "_reduce_scatter_base_": "reduce-scatter",
         "all_to_all_single": "all-to-all", "alltoall_": "all-to-all",
         "alltoall_base_": "all-to-all",
         "broadcast": "collective-permute", "broadcast_": "collective-permute"}
#: ops of the two namespaces that move no tensor between processes
_NO_MOVE = ("wait_tensor", "_wrap_tensor_autograd", "barrier",
            "monitored_barrier_")


class CollectiveCounter(TorchDispatchMode):
    """A dispatch mode that counts the functional collectives run under
    it on this process: ``counts`` and output ``nbytes`` by the
    reference's kinds.  An op on placed tensors (``DTensor``) is left to
    DTensor (``NotImplemented``), so that the collectives its sharding
    rules issue inside the op come through this mode too; a collective
    of a kind the reference does not name raises."""

    def __init__(self):
        super().__init__()
        self.counts = dict.fromkeys(COLLECTIVES, 0)
        self.nbytes = dict.fromkeys(COLLECTIVES, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        self.record(func, out)
        return out

    def record(self, func, out) -> None:
        """Count ``func`` with its output ``out`` if it is a collective."""
        if func.namespace not in ("_c10d_functional", "c10d"):
            return
        name = func._overloadpacket.__name__
        if name in _NO_MOVE:
            return
        kind = _KIND.get(name)
        if kind is None:
            raise ValueError(f"collective {func} has no reference kind")
        self.counts[kind] += 1
        self.nbytes[kind] += sum(t.numel() * t.element_size()
                                 for t in tree_leaves(out)
                                 if isinstance(t, torch.Tensor))

    def as_dict(self) -> dict:
        """The reference's ``collective_bytes`` dict: output bytes by
        kind, and their ``total``."""
        return {**self.nbytes, "total": sum(self.nbytes.values())}


class FunctionalGather(RuntimeError):
    """A functional all-gather ran under :class:`NoFunctionalGather`."""


class NoFunctionalGather(CollectiveCounter):
    """A :class:`CollectiveCounter` that refuses DTensor's functional
    all-gather (``_c10d_functional``, the op of its ``Shard`` ->
    ``Replicate``), which a gloo group of CUDA tensors does not survive
    on some torch versions (ROADMAP Queue 3 item 18): it raises
    :class:`FunctionalGather` before the op runs, or with
    ``raises=False`` counts it in ``fired`` and lets it run.  Every
    collective is counted as by :class:`CollectiveCounter`."""

    def __init__(self, raises: bool = True):
        super().__init__()
        self.raises, self.fired = raises, 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.namespace == "_c10d_functional" and \
                "all_gather" in func._overloadpacket.__name__:
            if self.raises:
                raise FunctionalGather(f"{func} under the guard")
            self.fired += 1
        return super().__torch_dispatch__(func, types, args, kwargs)


def collective_bytes(fn, *args) -> dict:
    """Output bytes of the collectives ``fn(*args)`` issues on this
    process, by kind, and their ``total`` (the reference's dict; it reads
    them from compiled HLO, the port runs the step once under
    :class:`CollectiveCounter`)."""
    with CollectiveCounter() as counter:
        fn(*args)
    return counter.as_dict()


@dataclasses.dataclass
class Roofline:
    flops: float            # per-device, loop-corrected
    flops_raw_hlo: float    # per-device, as the cost dict reports it
    hbm_bytes: float        # per-device, loop-corrected
    coll_bytes: float
    compute_s: float
    memory_s: float
    collective_s: float
    bottleneck: str
    model_flops: float
    useful_ratio: float
    loop_factor: float      # corrected / raw

    def as_dict(self):
        return dataclasses.asdict(self)


def analyze(cost: dict, coll: dict, *, model_flops_per_device: float,
            jaxpr_flops_per_device: float | None = None,
            machine: Machine | None = None) -> Roofline:
    """Derive the three terms from a cost dict (``flops``, ``bytes
    accessed``) and collective bytes (``total``).  When a counted step's
    FLOPs are supplied (``jaxpr_cost.step_flops``) the compute term uses
    them and the byte count is scaled by the same factor over the raw
    FLOPs, as the reference does for loop bodies its cost analysis counts
    once.  ``machine`` defaults to :func:`current_machine`."""
    if machine is None:
        machine = current_machine()
    raw_flops = float(cost.get("flops", 0.0))
    raw_bytes = float(cost.get("bytes accessed", 0.0))
    if jaxpr_flops_per_device and raw_flops > 0:
        factor = max(jaxpr_flops_per_device / raw_flops, 1.0)
    else:
        factor = 1.0
    flops = raw_flops * factor if factor > 1.0 else raw_flops
    if jaxpr_flops_per_device:
        flops = jaxpr_flops_per_device
    hbm = raw_bytes * factor
    cb = float(coll.get("total", 0))
    terms = {
        "compute": flops / machine.peak_flops,
        "memory": hbm / machine.hbm_bw,
        "collective": cb / machine.link_bw if machine.link_bw else 0.0,
    }
    bottleneck = max(terms, key=terms.get)
    return Roofline(
        flops=flops, flops_raw_hlo=raw_flops, hbm_bytes=hbm, coll_bytes=cb,
        compute_s=terms["compute"], memory_s=terms["memory"],
        collective_s=terms["collective"], bottleneck=bottleneck,
        model_flops=model_flops_per_device,
        useful_ratio=(model_flops_per_device / flops) if flops else 0.0,
        loop_factor=factor,
    )


def model_flops(cfg, shape, n_devices: int) -> float:
    """MODEL_FLOPS = 6·N·D (dense) / 6·N_active·D (MoE) per step, where D =
    tokens processed; decode steps process global_batch tokens."""
    n_params = active_param_count(cfg)
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        factor = 6.0
    elif shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        factor = 2.0
    else:  # decode: one token per sequence
        tokens = shape.global_batch
        factor = 2.0
    return factor * n_params * tokens / n_devices


def active_param_count(cfg) -> float:
    """Parameter count excluding inactive experts (MoE uses top_k of E),
    from the parameter tree's shapes; nothing is allocated."""
    from repro_torch.models.transformer import param_shapes
    from repro_torch.pytree import tree_paths

    def leaf_count(path, leaf):
        shape, _ = leaf
        n = 1
        for d in shape:
            n *= d
        name = path[-1]
        if (name in ("w_up", "w_gate", "w_down") and len(shape) >= 3
                and cfg.n_experts):
            # expert-stacked: count only the top-k active fraction
            n = n * cfg.top_k / cfg.n_experts
        if name == "embed":
            # embedding gathers are not 6ND matmul work; count once (the
            # unembed matmul is counted via `unembed` or the tied read).
            n = 0 if not cfg.tie_embeddings else n
        return n

    return float(sum(leaf_count(p, s)
                     for p, s in tree_paths(param_shapes(cfg))))

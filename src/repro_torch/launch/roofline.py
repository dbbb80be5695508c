"""FoG roofline model on the card (port of ``repro.launch.roofline``), and
the work accounting the card's kernel bounds are drawn from.

The paper's energy claim is a traffic claim: FoG wins because the grove
walk stays on chip.  :class:`RooflineModel` says, per backend, how far a
measured eval is from the time the modeled bytes and FLOPs need, from
what the engine already knows (the pack's shape and packed table bytes,
the hop statistics).  Its traffic classes are the JAX package's, by the
root of the backend's name:

* **per-hop** (``reference``, ``pallas``, anything not below): every loop
  iteration re-reads each lane's grove slice of the packed tables
  (``table_bytes / n_groves`` a lane, dtype-aware), its fp32 row, its
  ``[O, C]`` fp32 probability state read and written, and
  ``_LANE_LOOP_BYTES`` of bookkeeping;
* **fused** (``fused*``): the tables once a launch (times ``chunks``)
  and each lane's row, knobs and outputs once (``lane_io_bytes``); the
  hops do not multiply the bytes;
* **ring** (``ring*``): the fused class's bytes; its compute is every
  lane's every iteration.

FLOPs: a lane-hop walks one grove per head, ``O t`` trees of (2 ops a
level x depth + C leaf adds), plus the MaxDiff gate (``8 O C``).

``ideal_s`` is the slower of bytes over ``peak_bw`` and FLOPs over
``peak_flops``; ``achieved`` is ideal over measured.  The specs are one
NVIDIA H100 SXM's published peaks (NVIDIA H100 Tensor Core GPU Datasheet,
https://resources.nvidia.com/en-us-tensor-core/nvidia-tensor-core-gpu-datasheet;
dense rates, at its full 700 W): :data:`H100_SXM` with the float32 rate
outside the tensor cores (the grove walk is scalar fp32 and integer
work), :data:`H100_SXM_BF16` with the dense bf16 tensor-core rate (an LM
step), and :data:`HOST_CPU`, an order-of-magnitude stand-in for the plain
path on a host.  ``ici_bw`` stays 0: one card has no interconnect to rate.

The second half is the work of each hand-written kernel counted from its
inputs (``bound_ms`` and the ``*_work`` functions): ``chip_smoke.py``
prints each kernel's time beside the bound these give.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ref


@dataclasses.dataclass(frozen=True)
class MachineSpec:
    """Peak rates the roofline is drawn against."""
    name: str
    peak_flops: float    # FLOP/s
    peak_bw: float       # HBM (main-memory) bytes/s
    ici_bw: float = 0.0  # interconnect bytes/s (ring backend); 0 = ignore


# one H100 SXM (the datasheet above): HBM3 rate and the float32 rate
# outside the tensor cores
H100_SXM = MachineSpec("h100-sxm", peak_flops=67e12, peak_bw=3.35e12)
# the same card at its dense bf16 tensor-core rate (an LM step's products)
H100_SXM_BF16 = MachineSpec("h100-sxm-bf16", peak_flops=989e12,
                            peak_bw=3.35e12)
# order-of-magnitude stand-in for a host running the plain path; override
# with a measured spec for real host numbers
HOST_CPU = MachineSpec("host-cpu", peak_flops=1e11, peak_bw=5e10)

SPECS = {s.name: s for s in (H100_SXM, H100_SXM_BF16, HOST_CPU)}

# fixed per-lane bookkeeping bytes a per-hop iteration touches: live mask,
# hop counter read+write, threshold and budget reads
_LANE_LOOP_BYTES = 20
# per-lane one-time fused traffic besides the fp32 row and outputs:
# start + thresh + budget (4 B each) + int8 live mask
_LANE_FUSED_IN_BYTES = 13


@dataclasses.dataclass(frozen=True)
class RooflineEstimate:
    """One backend's modeled traffic/compute and the resulting bound."""
    backend: str
    spec: MachineSpec
    bytes_moved: float
    flops: float

    @property
    def memory_s(self) -> float:
        return self.bytes_moved / self.spec.peak_bw

    @property
    def compute_s(self) -> float:
        return self.flops / self.spec.peak_flops

    @property
    def bound(self) -> str:
        return "memory" if self.memory_s >= self.compute_s else "compute"

    @property
    def ideal_s(self) -> float:
        """No-overlap roofline time: the slower of the two terms."""
        return max(self.memory_s, self.compute_s)

    def achieved(self, measured_s: float) -> float:
        """Fraction of the roofline the measurement reaches (0 when the
        measurement is missing/zero -- never a division error)."""
        if not measured_s or measured_s <= 0 or self.ideal_s <= 0:
            return 0.0
        return self.ideal_s / measured_s

    def to_dict(self, measured_s: float | None = None) -> dict:
        d = {"backend": self.backend, "spec": self.spec.name,
             "bytes_moved": self.bytes_moved, "flops": self.flops,
             "memory_s": self.memory_s, "compute_s": self.compute_s,
             "bound": self.bound, "ideal_s": self.ideal_s}
        if measured_s is not None:
            d["achieved_pct"] = round(100.0 * self.achieved(measured_s), 4)
        return d


class RooflineModel:
    """Analytic FoG roofline for one packed field of groves.

    pack:       a :class:`~repro_torch.forest.pack.ForestPack` -- supplies
                the head/grove/tree/class shape and the dtype-aware table
                bytes
    n_features: width of the input rows
    spec:       :class:`MachineSpec` or its name (default: one H100 SXM)
    """

    def __init__(self, pack, n_features: int,
                 spec: MachineSpec | str = H100_SXM):
        self.pack = pack
        self.n_features = int(n_features)
        self.spec = SPECS[spec] if isinstance(spec, str) else spec

    # -- per-unit terms ---------------------------------------------------
    @property
    def lane_hop_flops(self) -> float:
        """Walk one grove per head for one lane: O·t trees × (compare +
        index update per level + C leaf accumulates), plus the MaxDiff
        gate over the [O, C] state."""
        p = self.pack
        walk = p.n_heads * p.grove_size * (2 * p.depth + p.n_classes)
        gate = 8 * p.n_heads * p.n_classes
        return float(walk + gate)

    @property
    def lane_hop_bytes(self) -> float:
        """Per-hop-backend traffic for one lane in one iteration: its
        grove's slice of the packed tables (dtype-aware), the fp32 row,
        the [O, C] fp32 probability state read+written, bookkeeping."""
        p = self.pack
        return (p.table_bytes / p.n_groves
                + 4 * self.n_features
                + 8 * p.n_heads * p.n_classes
                + _LANE_LOOP_BYTES)

    @property
    def lane_io_bytes(self) -> float:
        """Fused per-lane one-time traffic: fp32 row + scalar knobs in,
        fp32 [O, C] proba + int32 hops out."""
        p = self.pack
        return (4 * self.n_features + _LANE_FUSED_IN_BYTES
                + 4 * p.n_heads * p.n_classes + 4)

    # -- per-backend estimates -------------------------------------------
    def estimate(self, backend: str, batch: int, *, iters: float,
                 hops_total: float | None = None, chunks: int = 1,
                 compact: bool = False) -> RooflineEstimate:
        """Model one evaluation.

        iters:      loop trip count the backend executed -- ``max_hops``
                    for the fixed-trip backends, the observed max hop
                    count for early-exit loops
        hops_total: Σ per-lane hops (``batch × mean_hops``); defaults to
                    ``batch × iters`` (no early exit)
        chunks:     fused launches per evaluation (each re-reads the
                    tables)
        compact:    live-lane compaction -- compute scales with Σ hops
                    instead of batch × iters

        ``backend`` may be any row name (``"fused-compact"``,
        ``"pallas-chunked"``, ...): the traffic class comes from its root
        (``fused*``, ``ring*``, the rest per-hop) and the estimate keeps
        the full name.
        """
        p = self.pack
        B = float(batch)
        if hops_total is None:
            hops_total = B * iters
        root = backend.split("-")[0]
        if root == "fused":
            byts = chunks * p.table_bytes + B * self.lane_io_bytes
            lane_hops = hops_total if compact else B * iters
            flops = lane_hops * self.lane_hop_flops
        elif root == "ring":
            byts = chunks * p.table_bytes + B * self.lane_io_bytes
            flops = B * iters * self.lane_hop_flops
        else:  # per-hop backends: reference / reference-lazy / pallas
            byts = B * iters * self.lane_hop_bytes
            flops = B * iters * self.lane_hop_flops
        return RooflineEstimate(backend=backend, spec=self.spec,
                                bytes_moved=float(byts), flops=float(flops))


# ---------------------------------------------------------------------------
# the hand-written kernels' work, counted from their inputs
# ---------------------------------------------------------------------------

HBM_BYTES_PER_S = H100_SXM.peak_bw
FP32_OPS_PER_S = H100_SXM.peak_flops
BF16_OPS_PER_S = H100_SXM_BF16.peak_flops


def bound_ms(n_bytes: float, n_ops: float,
             ops_per_s: float = FP32_OPS_PER_S) -> tuple[float, str]:
    """Least time for the work: the larger of bytes over the memory rate
    and operations over the peak rate for their type (default fp32)."""
    tb, to = n_bytes / HBM_BYTES_PER_S * 1e3, n_ops / ops_per_s * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def fused_work(pack, x: torch.Tensor, start: torch.Tensor,
               hops: torch.Tensor) -> dict:
    """The work of one fused evaluation of ``x`` from ``start`` that ran
    ``hops`` hops per lane, counted from these inputs:

    ``bytes``     each entry the walk reaches read once (the distinct tree
                  nodes, leaf rows, per-tree scales and ``x`` entries the
                  plain walk visits), the lane vectors read once and the
                  outputs written once;
    ``ops``       the arithmetic of every lane-hop;
    ``chain``     the dependent loads the function needs in a row: one
                  tree's walk, ``d`` levels of (node, then ``x[feature]``)
                  and one leaf row, ``2d + 1`` -- every walk of every hop
                  can start at once, since a lane's grove sequence does not
                  depend on the gate (the gate's in-order arithmetic, hop
                  by hop, is left unpriced);
    ``serial_chain``  the same loads when the slowest lane walks its hops'
                  heads and trees one after another, as the first port's
                  kernel does: ``max hops x O x t x (2d + 1)``;
    ``gathered``  the bytes the walk gathers counting every repeat.
    """
    feat, thr, leaf, ts, ls = pack.layout("fused")
    thr = ref.dequantize_tables(thr, leaf, ts, ls)[0].reshape(-1)
    feat = feat.reshape(-1)
    O, G, t, N = pack.feature.shape
    d, C, tb = pack.depth, pack.n_classes, pack.threshold.element_size()
    B, F = x.shape
    hops = hops.long()
    trees, nodes, xs, leaves = [], [], [], []
    for j in range(int(hops.max())):
        lane = torch.nonzero(hops > j).squeeze(1)      # lanes that walked j
        g = (start[lane].long() + j) % G
        for o in range(O):
            tree = ((o * G + g) * t)[:, None] + torch.arange(
                t, device=x.device)[None, :]           # [n, t] tree ids
            idx = torch.zeros_like(tree)
            for _ in range(d):
                node = tree * N + idx
                f = feat[node].long()
                nodes.append(node.reshape(-1))
                xs.append((lane[:, None] * F + f).reshape(-1))
                xv = x.reshape(-1)[lane[:, None] * F + f]
                idx = 2 * idx + 1 + (xv > thr[node]).long()
            trees.append(tree.reshape(-1))
            leaves.append((tree * (N + 1) + idx - N).reshape(-1))
    n = {k: int(torch.unique(torch.cat(v)).numel())
         for k, v in (("trees", trees), ("nodes", nodes), ("x", xs),
                      ("leaves", leaves))}
    lane_hops = float(hops.sum())
    n_bytes = (n["nodes"] * (4 + tb) + n["leaves"] * C * tb
               + n["trees"] * 2 * 4 + n["x"] * 4
               + 3 * B * 4                       # start, thresh, budget
               + B * O * C * 4 + B * 4)          # proba, hops
    # per lane-hop and head: t*d compares, t*C leaf adds (+ t*C dequantize
    # multiplies at int8), C mean divides, C adds, 2C normalising divides,
    # 2C max compares
    per = O * (t * d + t * C * (2 if pack.precision == "int8" else 1)
               + 6 * C)
    return {"bytes": n_bytes, "ops": lane_hops * per, "distinct": n,
            "chain": 2 * d + 1,
            "serial_chain": int(hops.max()) * O * t * (2 * d + 1),
            "gathered": lane_hops * O * t * (d * (4 + tb + 4) + C * tb)}


def ssd_work(B, nc, Q, H, P, N, itemsize) -> dict:
    """ssd_chunk's work from its shapes: ``bytes`` x, a, B, C read once and
    y, states written once (the tensor-core kernel reads x once, so its
    design moves these bytes too; C and B come in once per block, mostly
    from L2); ``ops`` the products the causal block needs (C.B^T once per
    chunk and the weighted sum over j <= i, the state sum over all j);
    ``ops_full`` the full [Q, Q] products, as the TPU kernel counts them;
    ``ops_sm90`` what the tensor-core kernel runs: per head the 64 x 64
    tiles on or below the diagonal of C.B^T (recomputed per head) and of
    W.x, and the states product; ``ops_simt`` what the SIMT kernel
    (csrc/ssd_chunk.cu) runs over its 64-wide tiles (Q, P and N rounded
    up to 64): C.B^T's tiles on or below the diagonal once per chunk, and
    per head W.x over those tiles and the states over the whole chunk."""
    BC = B * nc
    n_bytes = itemsize * BC * (2 * Q * H * P + H * Q + 2 * Q * N + H * P * N)
    pairs = Q * (Q + 1) // 2
    ops_ = BC * (2 * pairs * N + 2 * pairs * H * P + 2 * Q * N * H * P)
    full = BC * (2 * Q * Q * N + 2 * Q * Q * H * P + 2 * Q * N * H * P)
    nt = -(-Q // 64)
    tiles = nt * (nt + 1) // 2
    sm90 = BC * H * (tiles * 64 * 64 * 2 * (N + P) + 2 * P * N * 256)
    Qp, Pp, Np = (64 * -(-w // 64) for w in (Q, P, N))
    simt = BC * (tiles * 64 * 64 * 2 * Np
                 + H * (tiles * 64 * 64 * 2 * Pp + 2 * Qp * Pp * Np))
    return {"bytes": n_bytes, "ops": ops_, "ops_full": full,
            "ops_sm90": sm90, "ops_simt": simt}


def flash_work(B, Sq, Sk, H, K, D, Dv, itemsize, causal=True) -> dict:
    """flash_attention's work from its shapes: ``bytes`` q, k, v read once
    and the output written once; ``pairs`` the (query, key) pairs each
    (batch, head) attends (causal: key j <= query i, both from 0); ``ops``
    the two products over them, 2 (D + Dv) FLOP a pair."""
    n_bytes = itemsize * B * (Sq * H * (D + Dv) + Sk * K * (D + Dv))
    if causal:
        n = min(Sq, Sk)          # rows i < Sk see i + 1 keys, the rest Sk
        pairs = n * (n + 1) // 2 + (Sq - n) * Sk
    else:
        pairs = Sq * Sk
    return {"bytes": n_bytes, "pairs": pairs,
            "ops": B * H * pairs * 2 * (D + Dv)}


def flash_design_ops(B, Sq, Sk, H, D, Dv, causal=True) -> int:
    """The FLOP the SIMT forward's design runs: each (q tile, K/V tile)
    pair it visits whole (``fa.fwd_tiles``), 2 (D + Dv) a (row, key)
    pair."""
    bq, bk, _ = fa.fwd_tiles(D, Dv)
    tiles = 0
    for t in range(-(-Sq // bq)):
        end = min(Sk, (t + 1) * bq, Sq) if causal else Sk
        tiles += -(-end // bk)
    return B * H * tiles * bq * bk * 2 * (D + Dv)


def bwd_work(B, Sq, Sk, H, K, D, Dv, causal=True) -> dict:
    """flash_attention's backward from its shapes: ``bytes`` q, k, v, o,
    do and lse read once and dq, dk, dv written once (fp32); ``ops`` the
    five products over the live pairs (s = q k^T recomputed, dp = do v^T,
    dv = p^T do, dq = ds k, dk = ds^T q), 2 (3 D + 2 Dv) FLOP a pair."""
    fwd = flash_work(B, Sq, Sk, H, K, D, Dv, 4, causal)
    n_bytes = 4 * B * (2 * Sq * H * (D + Dv) + 2 * Sk * K * (D + Dv)
                       + H * Sq)
    return {"bytes": n_bytes, "pairs": fwd["pairs"],
            "ops": B * H * fwd["pairs"] * 2 * (3 * D + 2 * Dv)}


def bwd_work_sm90(B, Sq, Sk, H, K, D, Dv, causal=True) -> dict:
    """The tensor-core backward's work from its shapes: ``bytes`` bf16 q,
    k, v, o, do read and dq, dk, dv written once, and the fp32 lse read
    once; ``ops`` the five products over the live pairs (as
    :func:`bwd_work`); ``design_ops`` the seven the two-pass design runs
    (s and dp in both passes), 2 (2 D + 2 Dp + 3 Dv) FLOP a pair, where
    dk and dq's products run over D padded to whole 64-column chunks, Dp
    (96 -> 128)."""
    fwd = flash_work(B, Sq, Sk, H, K, D, Dv, 2, causal)
    n_bytes = (2 * B * (2 * Sq * H * (D + Dv) + 2 * Sk * K * (D + Dv))
               + 4 * B * H * Sq)
    n_pairs = B * H * fwd["pairs"]
    return {"bytes": n_bytes, "pairs": fwd["pairs"],
            "ops": n_pairs * 2 * (3 * D + 2 * Dv),
            "design_ops": n_pairs * 2 * (2 * D + 2 * fa.sm90_padded(D)
                                         + 3 * Dv)}


def ssd_bwd_work(B, nc, Q, H, P, N, itemsize=4) -> dict:
    """ssd_chunk's backward from its shapes: ``bytes`` xbar, a, B, C, dy
    and dstates read once and dxbar, da, dB, dC written once (``itemsize``
    bytes each: 4 fp32, 2 bf16);
    ``ops`` the products it needs: per chunk S = C B^T, dC = dS B and dB +=
    dS^T C over the causal pairs (2 N FLOP a pair each), and per (chunk,
    head) dy x^T and W^T dy over the causal pairs (2 P each), and B dst^T
    and x dst over the whole chunk (2 Q P N each); ``design_ops`` what the
    tensor-core backward runs (csrc/ssd_chunk_bwd_sm90.cu) over its 64 x
    64 tiles on or below the diagonal: per chunk S, dC and dB; per (chunk,
    head) dW in the ds pass, S^T, dW^T and W^T dy in the dx pass, and G
    and x dst over the whole chunk; ``simt_ops`` what the SIMT backward
    (csrc/ssd_chunk_bwd.cu) runs over its 64-wide tiles (Q, P and N
    rounded up to 64): per chunk S, dC and dB over the tiles on or below
    the diagonal; per (chunk, head) dW and W^T dy over those tiles, and G
    and x dst over the whole chunk."""
    BC = B * nc
    n_bytes = itemsize * BC * (3 * Q * H * P + 2 * H * Q + 4 * Q * N
                               + H * P * N)
    pairs = Q * (Q + 1) // 2
    ops_ = BC * (3 * 2 * pairs * N
                 + H * (2 * 2 * pairs * P + 2 * 2 * Q * P * N))
    nt = -(-Q // 64)
    tile = 64 * 64 * 2 * nt * (nt + 1) // 2   # FLOP a unit of depth
    design = BC * (3 * tile * N + H * (3 * tile * P + tile * N
                                       + 2 * 2 * 64 * nt * P * N))
    Qp, Pp, Np = (64 * -(-w // 64) for w in (Q, P, N))
    simt = BC * (3 * tile * Np + H * (2 * tile * Pp + 2 * 2 * Qp * Pp * Np))
    return {"bytes": n_bytes, "pairs": pairs, "ops": ops_,
            "design_ops": design, "simt_ops": simt}

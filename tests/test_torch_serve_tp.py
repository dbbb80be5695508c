"""repro_torch's serving steps tensor-parallel over ``model``
(``make_prefill_step`` / ``make_serve_step(..., mesh=)``, plain and FoG) on
spawned gloo ranks on the CPU, and the top-2 gate's partials and merge in
one process.

Each rank computes attention, MLA, Mamba-2, the dense FFN, MoE, the
embedding and the unembedding on its parameter blocks along ``model``, as
JAX's GSPMD program does (``serve.decode``).  The products are split, so the outputs
are not bit-equal to one device; the bars:

  * fp32: every output (the logits and every cache leaf, ``full_tensor()``)
    within ``FP32_BAR`` of its scale (max |x|) of the one-process step's,
    or within twice the one-process step's own distance from a float64 run
    where that is larger (jamba's Mamba states after the prefill: the fp32
    step itself lies ~8e-6 of the scale from float64 there), and the logits within ``FP32_BAR + JAX_BAR`` of their scale of JAX's
    one-device step on the carried weights (``JAX_BAR`` is the bar at which
    ``tests/test_torch_lm.py`` holds the one-process step to JAX), computed
    in the test process;
  * bf16: the relative L2 distance of each output from the fp32
    one-process step on the same weights (the bf16 weights cast up) at
    most twice the bf16 one-process step's own distance, plus 2^-9;
  * exact: the embedding's output bit-equal to one device's, the greedy
    tokens and the hops equal (every lane's threshold is 0 or 2, far from
    any margin), the residual stream after each layer, each gate's
    margins and the hops identical on the ``model`` ranks, and the steps
    bit-equal run to run.  In bf16 the logits are bf16 values, and a
    lane's two largest can tie or lie an ulp apart: the bf16 runs are fed
    the one-process step's tokens, and a lane whose own greedy token
    differs must have its one-process top two within the step's bar of
    each other (relative to the logits' scale: the mesh's allowed
    distance plus the one-process step's own, ``3 d + 2^-9``).

Each step's gathers are recorded: no parameter is gathered along
``model``, no ``all_gather`` is handed a parameter's block, and no Mamba
cache leaf is gathered (the state and the conv tails are the rank's own
blocks); MLA's latent and rope key, sequence-sharded at rest, still are,
layer by layer.  Each rank's parameter bytes at rest equal the sum of its
blocks by JAX's ``PartitionSpec`` and, in the step, the sum of its blocks
along ``model``; each cache block after each step is the block JAX's
``cache_shardings`` ``PartitionSpec`` gives the rank.

Spawns (``file://`` rendezvous, as ``tests/test_torch_serve_mesh.py``):
2 ranks on ``(1, 2)`` and 4 on ``(2, 2)`` ``("data", "model")``.  Configs:
tinyllama (GQA, heads on ``model``), gemma-2b (one KV head: ``wk``/``wv``
whole, the cache's sequence on ``model``, tied embeddings), grok with
``moe_tp_within_expert`` (the router's experts gathered, each expert's
``d_ff`` split), mamba2-2.7b (pure Mamba: its heads, ``d_inner`` and N on
``model``), minicpm3-4b (MLA with its heads on ``model``), minicpm3 with 3
heads (MLA by its LoRA ranks, ``w_o`` on ``d_model``), mamba2 with 3 heads
of 64 (``d_inner`` on ``model``, the heads whole: a rank's block of
``d_inner`` cuts a head), and ``tests/test_torch_train_mesh.py``'s narrowed
deepseek (MLA on the heads; 3 experts: TP within the expert; a shared
expert; an odd vocabulary: the embedding and unembedding on ``d_model``)
and jamba (Mamba on the heads; attention with one KV head; 8 experts:
expert parallelism).  The ranks import only the port; JAX runs in the
test process."""
import functools
import math
import time
from datetime import timedelta

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402

import test_torch_train_mesh as TM  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.core.policy import FogPolicy  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.top2_confidence import partial_runs  # noqa: E402
from repro_torch.launch import sharding as S  # noqa: E402
from repro_torch.launch.mesh import dp_rank, model_rank  # noqa: E402
from repro_torch.models import fog_exit  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.carry import params_to_jax  # noqa: E402
from repro_torch.models.layers import MetaDraws  # noqa: E402
from repro_torch.serve import decode as D  # noqa: E402

# case name -> (arch, the smoke config's overrides)
CONFIGS = {"tinyllama-1.1b": ("tinyllama-1.1b", {}),
           "gemma-2b": ("gemma-2b", {}),
           "grok-1-314b": ("grok-1-314b", {"moe_tp_within_expert": True}),
           "mamba2-2.7b": ("mamba2-2.7b", {}),
           "minicpm3-4b": ("minicpm3-4b", {}),
           "minicpm3-4b-3-heads": ("minicpm3-4b", {"n_heads": 3}),
           "mamba2-2.7b-3-heads": ("mamba2-2.7b", {"d_model": 96,
                                                   "ssm_head_dim": 64}),
           **{a: (a, over) for a, over in TM.NARROW.items()}}
LINE = ((1, 2), ("data", "model"))
GRID = TM.GRID
B, SEQ, MAX_SEQ, N_DECODE = 4, 16, 24, 3
# per lane (2 a dp rank on (2, 2)): exit at the first gate, never exit by
# margin, never but for a budget of one grove
THRESH = [0.0, 2.0, 2.0, 2.0]
BUDGET = [9, 9, 1, 9]
FP32_BAR = 1e-5
JAX_BAR = 1e-4
BF16_SLACK = 2.0 ** -9
DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16}
# the (2, 2) spawn's cases: (config, dtype, FSDP)
GRID_CASES = (("grok-1-314b", "fp32", "auto"),
              ("grok-1-314b", "fp32", "forced"),
              ("tinyllama-1.1b", "bf16", "forced"),
              ("mamba2-2.7b", "bf16", "auto"),
              ("minicpm3-4b", "bf16", "forced"),
              ("minicpm3-4b-3-heads", "fp32", "auto"),
              ("mamba2-2.7b-3-heads", "fp32", "forced"))


def port_cfg(name):
    arch, over = CONFIGS[name]
    return smoke_config(arch).scaled(**over)


def jax_cfg(name):
    from repro.configs import smoke_config as jsmoke

    arch, over = CONFIGS[name]
    return jsmoke(arch).scaled(**over)


def prompt(cfg):
    g = torch.Generator().manual_seed(1)
    return torch.randint(0, cfg.vocab_size, (B, SEQ), dtype=torch.int32,
                         generator=g)


def weights(cfg, dtype=torch.float32):
    """The config's fp32 weights from seed 0 (JAX's distributions), in
    ``dtype``."""
    return cast(T.init_params(cfg, torch.Generator().manual_seed(0),
                              torch.float32, device="cpu"), dtype)


def cast(lm, dtype):
    """``lm`` in ``dtype``, the MoE router kept in fp32 (as a model built
    in ``dtype``)."""
    return S.rebuild(lm, {k: p.detach() if k.endswith("router")
                          else p.detach().to(dtype)
                          for k, p in lm.named_parameters()})


def leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaves(v, path + (k,))
    elif isinstance(tree, (list, tuple)) and not isinstance(tree, S.Spec):
        for i, v in enumerate(tree):
            yield from leaves(v, path + (i,))
    else:
        yield path, tree


def run_steps(cfg, dtype, params, mesh=None, tokens=None, blocks=None):
    """A prefill, ``N_DECODE`` greedy decode and ``N_DECODE + 1`` FoG steps
    (the last at threshold 0 for every lane) on one process or on
    ``mesh``; each step's token is the last step's argmax, or ``tokens[i]``
    where given.  Returns ([(logits, cache, hops or None)], tokens fed),
    the outputs whole (``full_tensor()`` on a mesh); ``blocks`` (a list)
    collects each step's cache as the rank's blocks (``to_local()``)."""
    kw = dict(param_dtype=dtype, mesh=mesh)
    pre, _ = D.make_prefill_step(cfg, "cpu", batch=B, seq_len=SEQ,
                                 max_seq=MAX_SEQ, **kw)
    dec, _ = D.make_serve_step(cfg, "cpu", batch=B, max_seq=MAX_SEQ, **kw)
    fog, _ = D.make_serve_step(cfg, "cpu", batch=B, max_seq=MAX_SEQ,
                               fog=True, policy=FogPolicy(backend="pallas"),
                               **kw)
    knobs = (torch.tensor(THRESH), torch.tensor(BUDGET, dtype=torch.int32))
    last = (torch.zeros(B), knobs[1])
    whole = (lambda t: t) if mesh is None else (lambda t: t.full_tensor())
    logits, cache = pre(params, prompt(cfg))
    if blocks is not None:
        blocks.append(S.map_leaves(lambda d: d.to_local(), cache))
    out, used = [(whole(logits), S.map_leaves(whole, cache), None)], []
    steps = [(dec, ())] * N_DECODE + [(fog, knobs)] * N_DECODE + [
        (fog, last)]
    for i, (fn, extra) in enumerate(steps):
        token = (out[-1][0].argmax(-1).to(torch.int32) if tokens is None
                 else tokens[i])
        used.append(token)
        res = fn(params, cache, token, SEQ + i, *extra)
        logits, cache = res[0], res[1]
        if blocks is not None:
            blocks.append(S.map_leaves(lambda d: d.to_local(), cache))
        out.append((whole(logits), S.map_leaves(whole, cache),
                    whole(res[2]) if len(res) > 2 else None))
    return out, used


def outputs(run):
    """(name, tensor) of every output of a run: each step's logits, each
    cache leaf."""
    for i, (logits, cache, _) in enumerate(run):
        yield f"step {i} logits", logits
        for path, t in leaves(cache):
            yield f"step {i} {path}", t


def rel_l2(a, b) -> float:
    a, b = a.double(), b.double()
    return float((a - b).norm() / max(float(b.norm()), 1e-30))


class Watch:
    """While on, records in a mesh step: the residual stream after each
    layer, each gate's margins, the embedding's output, every
    ``DTensor.redistribute`` of a parameter (name, placements before and
    after), the storage and shape of every ``dist.all_gather`` input, and
    the names of the cache leaves each layer gathers along ``model``
    (``serve.decode.LayerShare.whole``)."""

    def __init__(self, names: dict):
        from torch.distributed.tensor import DTensor

        self.names, self.h, self.margins, self.embeds = names, [], [], []
        self.moves, self.gathered, self.shapes = [], set(), set()
        self.cache_gathers = set()
        self.saved = (T._apply_layer_decode, T._layer_seq,
                      fog_exit._gate_margin, T.embed_tokens,
                      DTensor.redistribute, dist.all_gather,
                      D.LayerShare.whole)
        (layer, seq, gate, embed, redistribute, gather,
         whole) = self.saved

        def on_layer(*a, **kw):
            out = layer(*a, **kw)
            self.h.append(out[0])
            return out

        def on_seq(*a, **kw):
            out = seq(*a, **kw)
            self.h.append(out[0])
            return out

        def on_gate(*a, **kw):
            out = gate(*a, **kw)
            self.margins.append(out)
            return out

        def on_embed(*a, **kw):
            out = embed(*a, **kw)
            self.embeds.append(out)
            return out

        def on_redistribute(d, *a, **kw):
            out = redistribute(d, *a, **kw)
            if id(d) in self.names:
                self.moves.append((self.names[id(d)], tuple(d.placements),
                                   tuple(out.placements)))
            return out

        def on_gather(parts, t, *a, **kw):
            self.gathered.add(t.untyped_storage().data_ptr())
            self.shapes.add(tuple(t.shape))
            return gather(parts, t, *a, **kw)

        def on_whole(share, cache):
            self.cache_gathers.update(
                k for k, dims in share.dims.items()
                if any(d is not None for _, d in leaves(dims)))
            return whole(share, cache)

        (T._apply_layer_decode, T._layer_seq, fog_exit._gate_margin,
         T.embed_tokens, DTensor.redistribute, dist.all_gather,
         D.LayerShare.whole) = (on_layer, on_seq, on_gate, on_embed,
                                on_redistribute, on_gather, on_whole)

    def close(self):
        from torch.distributed.tensor import DTensor

        (T._apply_layer_decode, T._layer_seq, fog_exit._gate_margin,
         T.embed_tokens, DTensor.redistribute, dist.all_gather,
         D.LayerShare.whole) = self.saved


def same_on_model_ranks(ts: list, mesh) -> tuple[int, int]:
    """(tensors checked, tensors not bit-identical on every ``model``
    rank)."""
    _, size = model_rank(mesh)
    group = mesh.get_group("model")
    bad = 0
    for t in ts:
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(size)]
        dist.all_gather(parts, t, group=group)
        bad += not all(torch.equal(p, parts[0]) for p in parts)
    return len(ts), bad


def bytes_of(lm) -> int:
    return sum(p.numel() * p.element_size() for p in lm.parameters())


def block_bytes(shape, spec, itemsize, sizes, axes=None) -> int:
    """Bytes of one device's block of a leaf of ``shape`` by JAX's
    ``spec``, counting only the mesh ``axes`` (default: all)."""
    n = math.prod(shape)
    for part in spec:
        for a in () if part is None else (
                part if isinstance(part, tuple) else (part,)):
            if axes is None or a in axes:
                n //= sizes[a]
    return n * itemsize


def token_ties(got, one, bars=None) -> list:
    """(step, lane, the one-process top-2 gap over the logits' scale, the
    step's bar or 0) of each lane whose greedy token from ``got``'s logits
    differs from ``one``'s."""
    out = []
    for i, ((g, _, _), (o, _, _)) in enumerate(zip(got, one)):
        for lane in (g.argmax(-1) != o.argmax(-1)).nonzero()[:, 0].tolist():
            top = o[lane].topk(2).values
            out.append((i, lane, float(top[0] - top[1])
                        / float(o[lane].abs().max()),
                        0.0 if bars is None else bars[i]))
    return out


def max_err(a, b) -> float:
    return float((a.double() - b.double()).abs().max()) / max(
        float(b.abs().max()), 1e-30)


def mesh_case(mesh, cfg, dtype, fsdp, specs, cache_specs, *, bar: str,
              repeat: bool) -> dict:
    """One config and dtype on ``mesh``: the one-process runs, the mesh
    run watched, and what the tests hold them to.  ``specs`` and
    ``cache_specs``: JAX's parameter and cache specs on the mesh."""
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    w = weights(cfg, dtype)
    one, tokens = run_steps(cfg, dtype, w)
    rec = {}
    oracle, _ = run_steps(
        cfg, torch.float32 if bar == "bf16" else torch.float64,
        cast(w, torch.float32 if bar == "bf16" else torch.float64),
        tokens=tokens)
    placed = S.shard_tree(w, mesh, S.param_shardings(cfg, mesh, w, fsdp))
    names = {id(p): k for k, p in placed.named_parameters()}
    watch = Watch(names)
    blocks = []
    try:
        got, used = run_steps(cfg, dtype, placed, mesh,
                              tokens=tokens if bar == "bf16" else None,
                              blocks=blocks)
    finally:
        watch.close()
    # each cache block == the block JAX's spec gives the rank; no Mamba
    # leaf's block is handed to a gather
    rec["cache_blocks"], rec["mamba_block_gathers"] = [0, 0], 0
    for (_, cache, _), local in zip(got, blocks, strict=True):
        for (path, t), (_, b) in zip(leaves(cache), leaves(local),
                                     strict=True):
            key = path[:1] + path[2:] if path[0] == "stack" else path
            rec["cache_blocks"][0] += 1
            rec["cache_blocks"][1] += not torch.equal(
                b, TM.block(t, cache_specs[key], coord, sizes))
            if path[-1] == "state" or "conv" in path:
                rec["mamba_block_gathers"] += tuple(b.shape) in watch.shapes
    rec["cache_gathers"] = sorted(watch.cache_gathers)
    rec["tokens_equal"] = all(torch.equal(a, b)
                              for a, b in zip(used, tokens, strict=True))
    rec["hops"] = [(g[2].tolist(), o[2].tolist()) for g, o in zip(got, one)
                   if o[2] is not None]
    if bar == "fp32":
        rec["err"] = [(what, max_err(a, b), max_err(b, c)) for (
            what, a), (_, b), (_, c) in zip(outputs(got), outputs(one),
                                            outputs(oracle), strict=True)]
        rec["logits"] = [g[0] for g in got]
        rec["ties"] = token_ties(got, one)
    else:
        rec["bf16"] = [(what, rel_l2(a, c), rel_l2(b, c)) for (
            what, a), (_, b), (_, c) in zip(outputs(got), outputs(one),
                                            outputs(oracle), strict=True)]
        rec["ties"] = token_ties(got, one, [
            3 * rel_l2(o[0], c[0]) + BF16_SLACK
            for o, c in zip(one, oracle)])
    # the embedding: each of the rank's lanes bit-equal to one device's
    r, n = dp_rank(mesh)
    rows = slice(r * B // n, (r + 1) * B // n)
    ids = [prompt(cfg)[rows]] + [t[rows, None] for t in used]
    rec["embeds"] = (len(watch.embeds), sum(
        not torch.equal(e, T.embed_tokens(w, cfg, t))
        for e, t in zip(watch.embeds, ids, strict=True)))
    rec["identical"] = same_on_model_ranks(
        watch.h + watch.margins + [g[2] for g in got if g[2] is not None],
        mesh)
    rec["margins"] = len(watch.margins)
    rec["model_moves"] = sorted({k for k, a, b in watch.moves
                                 if a[-1] != b[-1]})
    rec["dp_moves"] = len(watch.moves)
    locals_ = {p.to_local().untyped_storage().data_ptr()
               for p in placed.parameters()}
    rec["gathered_blocks"] = len(locals_ & watch.gathered)
    step = D.step_params(cfg, mesh, placed)
    want_step = want_rest = 0
    for k, p in placed.named_parameters():
        spec = TM.jax_spec(specs, k)
        item = p.element_size()
        want_rest += block_bytes(p.shape, spec, item, sizes)
        want_step += block_bytes(p.shape, spec, item, sizes, ("model",))
    rest = sum(p.to_local().numel() * p.element_size()
               for p in placed.parameters())
    rec["bytes"] = {"rest": (rest, want_rest),
                    "step": (bytes_of(step), want_step),
                    "whole": bytes_of(w)}
    if repeat:
        again, _ = run_steps(cfg, dtype, placed, mesh)
        rec["repeat_equal"] = all(
            torch.equal(a, b) for (_, a), (_, b) in zip(
                outputs(again), outputs(got), strict=True))
    return rec


# ------------------------------------------------------------ the ranks

def _line_rank(rank, world, case, out_dir):
    """2 ranks on (1, 2): every config in fp32 and bf16."""
    from torch.distributed.device_mesh import init_device_mesh

    mesh = init_device_mesh("cpu", LINE[0], mesh_dim_names=LINE[1])
    rec = {"model": model_rank(mesh)}
    for arch in CONFIGS:
        cfg = port_cfg(arch)
        for name in DTYPES:
            rec[(arch, name)] = mesh_case(
                mesh, cfg, DTYPES[name], None,
                case["specs"][(arch, "line", "auto")],
                case["cache"][(arch, "line")], bar=name,
                repeat=name == "fp32")
    torch.save(rec, f"{out_dir}/rank{rank}.pt")


def _grid_rank(rank, world, case, out_dir):
    """4 ranks on (2, 2): ``GRID_CASES``."""
    from torch.distributed.device_mesh import init_device_mesh

    mesh = init_device_mesh("cpu", GRID[0], mesh_dim_names=GRID[1])
    rec = {"model": model_rank(mesh), "dp": dp_rank(mesh)}
    for arch, name, fsdp in GRID_CASES:
        rec[(arch, name, fsdp)] = mesh_case(
            mesh, port_cfg(arch), DTYPES[name], TM.FSDP[fsdp],
            case["specs"][(arch, "grid", fsdp)],
            case["cache"][(arch, "grid")], bar=name, repeat=False)
    torch.save(rec, f"{out_dir}/rank{rank}.pt")


# ------------------------------------------------------------ JAX's side

@functools.lru_cache(maxsize=None)
def jax_logits(arch: str) -> list:
    """JAX's one-device steps (jitted) on the ranks' weights carried over
    (``params_to_jax``): the prefill, then the decode and FoG steps fed
    the one-process port's greedy tokens (the fp32 mesh run's, which the
    tests hold equal); each step's logits."""
    import jax
    import jax.numpy as jnp

    from repro.core import FogPolicy as JPolicy
    from repro.models import fog_exit as jfog
    from repro.models import transformer as JT

    jcfg = jax_cfg(arch)
    cfg = port_cfg(arch)
    w = weights(cfg)
    jp = jax.tree.map(jnp.asarray, params_to_jax(w, cfg))
    _, tokens = run_steps(cfg, torch.float32, w)
    pre = jax.jit(lambda p, t: JT.prefill(p, jcfg, tokens=t,
                                          max_seq=MAX_SEQ))
    dec = jax.jit(lambda p, t, c, n: JT.decode_step(p, jcfg, t, c, n))
    fog = jax.jit(lambda p, t, c, n, th, b: jfog.decode_step_fog(
        p, jcfg, t, c, n, JPolicy(threshold=th, hop_budget=b)))
    logits, cache = pre(jp, jnp.asarray(prompt(cfg)))
    out = [np.asarray(logits)]
    budget = np.asarray(BUDGET, np.int32)
    for i, tok in enumerate(tokens):
        tok, length = jnp.asarray(tok.numpy()), jnp.int32(SEQ + i)
        if i < N_DECODE:
            logits, cache = dec(jp, tok, cache, length)
        else:
            th = np.asarray(THRESH if i < 2 * N_DECODE else [0.0] * B,
                            np.float32)
            logits, cache, _ = fog(jp, tok, cache, length, th, budget)
        out.append(np.asarray(logits))
    return out


def jax_specs(arch: str, mesh, fsdp) -> dict:
    """JAX's parameter specs of the config on ``mesh`` (names and sizes),
    by JAX path."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import AbstractMesh, PartitionSpec as P

    from repro.launch import sharding as js
    from repro.models import transformer as JT

    jcfg = jax_cfg(arch)
    jp = jax.eval_shape(lambda k: JT.init_params(jcfg, k, jnp.float32),
                        jax.random.key(0))
    flat = jax.tree_util.tree_flatten_with_path(
        js.param_shardings(jcfg, AbstractMesh(*mesh), jp, fsdp=fsdp),
        is_leaf=lambda x: isinstance(x, P))[0]
    return {tuple(str(getattr(k, "key", getattr(k, "idx", k)))
                  for k in path): tuple(s) for path, s in flat}


def jax_cache_specs(arch: str, mesh) -> dict:
    """JAX's cache specs of the config on ``mesh`` at ``B`` lanes and
    ``MAX_SEQ`` positions, by the port's cache path (a stack leaf's less
    its leading None, keyed without the repeat's index)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import AbstractMesh, PartitionSpec as P

    from repro.launch import sharding as js
    from repro.models import transformer as JT

    jcfg = jax_cfg(arch)
    shape = jax.eval_shape(lambda: JT.cache_init(jcfg, B, MAX_SEQ,
                                                 jnp.float32))
    flat = jax.tree_util.tree_flatten_with_path(
        js.cache_shardings(jcfg, AbstractMesh(*mesh), shape),
        is_leaf=lambda x: isinstance(x, P))[0]
    out = {}
    for path, spec in flat:
        key = tuple(getattr(k, "key", getattr(k, "idx", k)) for k in path)
        out[key] = tuple(spec)[1:] if key[0] == "stack" else tuple(spec)
    return out


def case_for(cases) -> dict:
    return {"specs": {(a, where, fsdp): jax_specs(
                a, LINE if where == "line" else GRID, TM.FSDP[fsdp])
                for a, where, fsdp in cases},
            "cache": {(a, where): jax_cache_specs(
                a, LINE if where == "line" else GRID)
                for a, where, _ in cases}}


# seconds a spawn may take, and a rank may wait in a collective: the
# suite runs beside other workers, and JAX's steps run in this process
# while the ranks work, so a rank can fall far behind its peer
RANKS_TIMEOUT_S = 300


def _rank_main(rank, world, init_file, fn, case, out_dir):
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world,
                            timeout=timedelta(seconds=RANKS_TIMEOUT_S))
    try:
        torch.set_num_threads(1)
        fn(rank, world, case, out_dir)
    finally:
        dist.destroy_process_group()


def run_ranks(world, fn, case, out_dir, meanwhile=None):
    """``test_torch_train_mesh.run_ranks``, with ``meanwhile()`` run in
    this process while the ranks work (JAX's steps)."""
    ctx = mp.start_processes(
        _rank_main, args=(world, str(out_dir / f"init-{fn.__name__}"), fn,
                          case, str(out_dir)),
        nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + RANKS_TIMEOUT_S
    try:
        if meanwhile is not None:
            meanwhile()
        while not ctx.join(timeout=max(deadline - time.monotonic(), 0.1)):
            if time.monotonic() > deadline:
                pytest.fail(f"{world} gloo ranks did not finish in "
                            f"{RANKS_TIMEOUT_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
            p.join(5)
    return [torch.load(out_dir / f"rank{r}.pt") for r in range(world)]


@pytest.fixture(scope="module")
def line_ranks(tmp_path_factory):
    case = case_for([(a, "line", "auto") for a in CONFIGS])
    return run_ranks(2, _line_rank, case, tmp_path_factory.mktemp("line"),
                     lambda: [jax_logits(a) for a in CONFIGS])


@pytest.fixture(scope="module")
def grid_ranks(tmp_path_factory):
    case = case_for([(a, "grid", f) for a, _, f in GRID_CASES])
    return run_ranks(4, _grid_rank, case, tmp_path_factory.mktemp("grid"))


def all_cases(line_ranks, grid_ranks):
    for r in line_ranks:
        for arch in CONFIGS:
            for name in DTYPES:
                yield f"(1, 2) {arch} {name}", r[(arch, name)]
    for r in grid_ranks:
        for key in GRID_CASES:
            yield f"(2, 2) {' '.join(key)}", r[key]


# ------------------------------------------------------------- the tests

@pytest.mark.parametrize("arch", sorted(CONFIGS))
def test_fp32_steps_within_the_bar_of_one_process(line_ranks, arch):
    """fp32 on (1, 2): every output (logits, every cache leaf) of the
    prefill, 3 decode and 4 FoG steps within 1e-5 of its scale of the
    one-process step's; the greedy tokens and the hops equal."""
    assert [r["model"] for r in line_ranks] == [(0, 2), (1, 2)]
    for r in line_ranks:
        rec = r[(arch, "fp32")]
        for what, err, own in rec["err"]:
            assert err <= max(FP32_BAR, 2 * own), (what, err, own)
        assert rec["tokens_equal"] and rec["ties"] == []
        assert all(a == b for a, b in rec["hops"]), rec["hops"]
        assert len(rec["hops"]) == N_DECODE + 1


@pytest.mark.parametrize("arch", sorted(CONFIGS))
def test_fp32_logits_within_the_bar_of_jax(line_ranks, arch):
    """fp32 on (1, 2): each step's logits within 1e-5 + 1e-4 of their
    scale of JAX's one-device step on the same (carried) weights."""
    want = jax_logits(arch)
    for r in line_ranks:
        got = r[(arch, "fp32")]["logits"]
        assert len(got) == len(want) == 2 * N_DECODE + 2
        for i, (g, w) in enumerate(zip(got, want)):
            scale = float(np.abs(w).max())
            err = float(np.abs(g.numpy() - w).max())
            assert err <= (FP32_BAR + JAX_BAR) * scale, (arch, i, err, scale)


@pytest.mark.parametrize("arch", sorted(CONFIGS))
def test_bf16_steps_within_the_bar_of_the_fp32_oracle(line_ranks, arch):
    """bf16 on (1, 2), fed the one-process tokens: each output's relative
    L2 distance from the fp32 one-process step on the bf16 weights cast
    up is at most twice the bf16 one-process step's, plus 2^-9; the hops
    equal; a greedy token differs only where the one-process top two lie
    within the step's bar of each other (the module docstring)."""
    for r in line_ranks:
        rec = r[(arch, "bf16")]
        for what, mesh_d, one_d in rec["bf16"]:
            assert mesh_d <= 2 * one_d + BF16_SLACK, (what, mesh_d, one_d)
        assert rec["tokens_equal"]
        assert all(gap <= bar for *_, gap, bar in rec["ties"]), rec["ties"]
        assert all(a == b for a, b in rec["hops"]), rec["hops"]


@pytest.mark.parametrize("key", GRID_CASES, ids="-".join)
def test_grid_steps_within_their_bars(grid_ranks, key):
    """4 ranks on (2, 2), FSDP automatic and forced: the same bars, each
    rank on its lanes."""
    assert sorted(r["dp"] + r["model"] for r in grid_ranks) == [
        (0, 2, 0, 2), (0, 2, 1, 2), (1, 2, 0, 2), (1, 2, 1, 2)]
    for r in grid_ranks:
        rec = r[key]
        if key[1] == "fp32":
            for what, err, own in rec["err"]:
                assert err <= max(FP32_BAR, 2 * own), (what, err, own)
            assert rec["ties"] == []
        else:
            for what, mesh_d, one_d in rec["bf16"]:
                assert mesh_d <= 2 * one_d + BF16_SLACK, (what, mesh_d,
                                                          one_d)
            assert all(gap <= bar for *_, gap, bar in rec["ties"]), rec[
                "ties"]
        assert rec["tokens_equal"]
        assert all(a == b for a, b in rec["hops"]), rec["hops"]


def test_embedding_is_bit_equal_to_one_device(line_ranks, grid_ranks):
    """The masked lookup of the rank's vocabulary rows summed over
    ``model`` (or the ``d_model`` blocks gathered) == one device's
    embedding of the rank's lanes, at every step."""
    for what, rec in all_cases(line_ranks, grid_ranks):
        n, bad = rec["embeds"]
        assert n == 2 * N_DECODE + 2 and bad == 0, (what, n, bad)


def test_replicated_values_are_identical_on_the_model_ranks(line_ranks,
                                                            grid_ranks):
    """The residual stream after each layer, each gate's margins (so
    ``live``) and the hops: ``torch.equal`` on every ``model`` rank."""
    for what, rec in all_cases(line_ranks, grid_ranks):
        n, bad = rec["identical"]
        assert bad == 0 and n > rec["margins"] > 0, (what, rec["identical"])


def test_no_parameter_block_is_gathered_along_model(line_ranks,
                                                    grid_ranks):
    """No parameter is gathered along ``model`` (no redistribution
    changes ``model``'s placement) and no ``all_gather`` is handed a
    parameter's block: attention, MLA, Mamba, the FFNs, MoE, the
    embedding and the unembedding compute on the rank's blocks."""
    for what, rec in all_cases(line_ranks, grid_ranks):
        assert rec["model_moves"] == [], (what, rec["model_moves"])
        assert rec["gathered_blocks"] == 0, what
    # FSDP forced on (2, 2): the data axis is gathered on use
    for r in grid_ranks:
        assert r[("grok-1-314b", "fp32", "forced")]["dp_moves"] > 0
        assert r[("grok-1-314b", "fp32", "auto")]["dp_moves"] == 0


def test_parameter_bytes_are_the_sum_of_the_jax_blocks(line_ranks,
                                                       grid_ranks):
    """At rest each rank holds the sum of its blocks by JAX's
    ``PartitionSpec``; in the step the sum of its blocks along
    ``model``, every leaf a block: about half of the whole model on a
    model axis of 2 (a little more: the norms, ``w_dkv`` and the leaves
    whose dimension does not divide stay whole)."""
    for what, rec in all_cases(line_ranks, grid_ranks):
        got, want = rec["bytes"]["step"]
        assert got == want, (what, got, want)
        got, want = rec["bytes"]["rest"]
        assert got == want, (what, got, want)
        assert rec["bytes"]["step"][0] < 0.6 * rec["bytes"]["whole"], what


def test_no_mamba_cache_leaf_is_gathered_along_model(line_ranks,
                                                     grid_ranks):
    """A Mamba layer's state and conv tails are the rank's own blocks
    (its heads and channels, or whole where the plan keeps them whole):
    no layer gathers them, and no ``all_gather`` takes a tensor of a
    Mamba cache block's shape.  MLA's latent and rope key, sequence-
    sharded at rest, are still gathered layer by layer, as the K/V of an
    attention layer whose one KV head puts the sequence on ``model``."""
    for what, rec in all_cases(line_ranks, grid_ranks):
        assert "state" not in rec["cache_gathers"], what
        assert "conv" not in rec["cache_gathers"], what
        assert rec["mamba_block_gathers"] == 0, what
        mla = "deepseek" in what or "minicpm3" in what
        assert ("c_kv" in rec["cache_gathers"]) == mla, (
            what, rec["cache_gathers"])
        kv = "gemma" in what or "jamba" in what
        assert ("k" in rec["cache_gathers"]) == kv, (
            what, rec["cache_gathers"])


def test_cache_blocks_are_the_jax_blocks(line_ranks, grid_ranks):
    """Each rank's block of every cache leaf after every step is the
    block JAX's ``cache_shardings`` ``PartitionSpec`` gives its mesh
    coordinates, in shape and position: the Mamba state on the heads
    (whole where they do not divide), the conv tails on their channels,
    K/V on the KV heads or the sequence, MLA's latent on the sequence."""
    for what, rec in all_cases(line_ranks, grid_ranks):
        n, bad = rec["cache_blocks"]
        assert n > 0 and bad == 0, (what, n, bad)


def test_mesh_steps_are_bit_equal_run_to_run(line_ranks):
    for r in line_ranks:
        for arch in CONFIGS:
            assert r[(arch, "fp32")]["repeat_equal"], arch


# ------------------------------------------------ the pieces, one process

def tied_rows(rng, B, C, splits, n):
    """[B, C] rows of few distinct values, with a row whose maximum is
    repeated in two blocks of each split, one whose maximum is in the last
    column only, one all equal, and one whose maximum sits once in each
    block of ``n`` columns, at the same column of each (only the blocks'
    offsets tell them apart)."""
    x = rng.integers(0, 5, (B, C)).astype(np.float32) / 4
    x[0] = 0.0
    for m in splits:
        x[0, C // m - 1] = x[0, C - C // m] = 1.0
    x[1] = 0.25
    x[1, -1] = 0.75
    x[2] = 0.5
    x[3] = 0.0
    x[3, 1::n] = 1.0
    return torch.from_numpy(x)


@functools.lru_cache(maxsize=None)
def jax_top2():
    """JAX's ``top2_confidence_ref``, jitted (one compile a shape)."""
    import jax

    from repro.kernels.ref import top2_confidence_ref

    return jax.jit(top2_confidence_ref)


@pytest.mark.parametrize("split", [1, 2, 3, 4])
@pytest.mark.parametrize("shape", [(5, 12), (4, 120), (4, 4800), (7, 24)])
def test_top2_partials_and_merge_equal_jax_on_whole_rows(split, shape):
    """The partials of each of ``split`` blocks (the kernel's runs a
    row, index offset by the block's first column), gathered in block
    order and merged == JAX's ``top2_confidence_ref`` of the whole rows
    bit for bit, ties across the split (margin 0) included."""
    import jax.numpy as jnp

    Bq, C = shape
    n = C // split
    x = tied_rows(np.random.default_rng(split * 31 + C), Bq, C,
                  [m for m in (1, 2, 3, 4) if C % m == 0], n)
    parts = torch.cat([ops.top2_partials(x[:, m * n:(m + 1) * n], m * n)
                       for m in range(split)], dim=-1)
    assert parts.shape == (3, Bq, split * partial_runs(Bq, n))
    got = ops.top2_merge(parts)
    want = torch.from_numpy(np.asarray(jax_top2()(jnp.asarray(x.numpy()))))
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert float(got[0]) == float(got[2]) == 0.0
    assert float(got[3]) == (1.0 if split == 1 else 0.0)
    assert torch.equal(got, ops.top2_confidence(x))


@pytest.mark.parametrize("nblk", [1, 2, 3, 7])
def test_top2_partials_ref_marks_runs_without_a_value(nblk):
    """A run of -inf (or past the block's end) has no maximum: both values
    -inf and the index ``NO_INDEX``; the merge passes over it."""
    x = torch.full((2, 10), float("-inf"))
    x[0, 3] = 0.5
    x[1, 9] = 0.25
    parts = ref.top2_partials_ref(x, 100, nblk)
    i1 = parts[2]
    assert (i1 == ref.NO_INDEX).sum() == 2 * nblk - 2
    assert int(i1[0].min()) == 103 and int(i1[1].min()) == 109
    assert torch.equal(ref.top2_merge_ref(parts),
                       ref.top2_confidence_ref(x))


def test_one_block_merge_is_the_one_launch_margin():
    """With one rank the partials then the merge == ``top2_confidence``'s
    one call bit for bit (the gate on a one-rank ``model`` axis)."""
    x = torch.rand(4, 32000, generator=torch.Generator().manual_seed(3))
    assert torch.equal(ops.top2_merge(ops.top2_partials(x)),
                       ops.top2_confidence(x))


ROLE_CASES = [("wq", S.Spec("data", "model", None), "out"),
              ("wq", S.Spec("model", None, None), "in"),
              ("wk", S.Spec(None, None, None), None),
              ("wo", S.Spec("model", None, "data"), "in"),
              ("wo", S.Spec(None, None, "model"), "out"),
              ("w_gate", S.Spec("data", "model"), "out"),
              ("w_down", S.Spec("model", "data"), "in"),
              ("w_gate", S.Spec("model", "data", None), "expert"),
              ("w_gate", S.Spec(None, None, "model"), "out"),
              ("w_down", S.Spec(None, "model", None), "in"),
              ("router", S.Spec(None, "model"), "out"),
              ("embed", S.Spec("model", "data"), "out"),
              ("embed", S.Spec("data", "model"), "in"),
              ("unembed", S.Spec("data", "model"), "out"),
              ("unembed", S.Spec("model", None), "in"),
              ("norm", S.Spec("model"), "out"),
              ("w_gate", S.Spec(("pod", "model"), None), "in"),
              # MLA: w_dq on the q LoRA rank, or whole
              ("w_dq", S.Spec("data", "model"), "out"),
              ("w_dq", S.Spec(None, None), None),
              # w_uq / w_uk / w_uv [r, H, e]: the heads, else the LoRA rank
              ("w_uq", S.Spec("data", "model", None), "out"),
              ("w_uq", S.Spec("model", None, None), "in"),
              ("w_uk", S.Spec(None, "model", None), "out"),
              ("w_uk", S.Spec("model", None, None), "in"),
              ("w_uv", S.Spec("data", "model", None), "out"),
              ("w_uv", S.Spec("model", None, None), "in"),
              ("w_uq", S.Spec(None, None, None), None),
              # w_o [H, dv, d]: the heads, else d_model (gathered after)
              ("w_o", S.Spec("model", None, "data"), "in"),
              ("w_o", S.Spec(None, None, "model"), "out"),
              ("w_o", S.Spec(None, None, None), None),
              # whole in the plan
              ("w_dkv", S.Spec("data", None), None),
              ("q_norm", S.Spec(None), None),
              ("kv_norm", S.Spec(None), None),
              # Mamba: the projections [d, C] on their output columns
              ("in_z", S.Spec("data", "model"), "out"),
              ("in_x", S.Spec(None, "model"), "out"),
              ("in_B", S.Spec(None, "model"), "out"),
              ("in_C", S.Spec("data", "model"), "out"),
              ("in_dt", S.Spec(None, "model"), "out"),
              ("in_dt", S.Spec("data", None), None),
              # the convs [K, C]: dim 1 is a channel, not contracted
              ("conv_x", S.Spec(None, "model"), "out"),
              ("conv_B", S.Spec(None, "model"), "out"),
              ("conv_C", S.Spec(None, "model"), "out"),
              ("conv_B", S.Spec(None, None), None),
              # the vectors on heads or features, or whole
              ("A_log", S.Spec("model"), "out"),
              ("D", S.Spec("model"), "out"),
              ("dt_bias", S.Spec("model"), "out"),
              ("conv_b_x", S.Spec("model"), "out"),
              ("A_log", S.Spec(None), None),
              ("conv_b_B", S.Spec(None), None),
              ("conv_b_C", S.Spec(None), None),
              # out_proj [d_inner, d]: row-parallel
              ("out_proj", S.Spec("model", "data"), "in"),
              ("out_proj", S.Spec("model", None), "in"),
              ("out_proj", S.Spec(None, "data"), None)]


@pytest.mark.parametrize("name,spec,role", ROLE_CASES,
                         ids=[f"{n}-{i}" for i, (n, _, _) in
                              enumerate(ROLE_CASES)])
def test_model_role_of_a_leaf(name, spec, role):
    assert S.model_role(name, spec) == role


@pytest.mark.parametrize("arch", sorted(CONFIGS))
def test_every_mixer_leaf_has_the_role_of_its_jax_spec(arch):
    """On ``(1, 2)`` the port's spec of every MLA and Mamba leaf ==
    JAX's, and its role is the one its dimension on ``model`` names:
    ``"out"`` on an output column, a head, a channel or a vector's
    feature; ``"in"`` on a contracted dimension (``w_uq``/``w_uk``/
    ``w_uv``'s LoRA rank, ``w_o``'s heads, ``out_proj``'s ``d_inner``);
    ``w_o`` on ``d_model`` ``"out"``; None where the plan keeps it
    whole."""
    from repro_torch.launch.mesh import MeshShape
    from repro_torch.models import mamba2, mla

    cfg = port_cfg(arch)
    lm = T.init_params(cfg, MetaDraws(), device="meta")
    specs = S.param_shardings(cfg, MeshShape(*LINE[::-1]), lm)
    want = jax_specs(arch, LINE, None)
    contracted = {"w_o": (0,), "out_proj": (0,), "w_uq": (0,),
                  "w_uk": (0,), "w_uv": (0,)}
    mixers = [(f"{at}.{k}", k) for at, mod in lm.named_modules()
              if isinstance(mod, (mla.MLA, mamba2.Mamba))
              for k, _ in mod.named_parameters()]
    assert bool(mixers) == (arch not in ("tinyllama-1.1b", "gemma-2b",
                                         "grok-1-314b"))
    for full, name in mixers:
        spec = specs[full]
        assert tuple(spec) == TM.jax_spec(want, full), full
        d = S.model_dim(spec)
        role = (None if d is None else
                "in" if d in contracted.get(name, ()) else "out")
        assert S.model_role(name, spec) == role, (full, spec)

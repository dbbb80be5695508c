"""The serve CLI: continuous batching + optional FoG early-exit decode
(port of ``repro.launch.serve``).

    python -m repro_torch.launch.serve --arch tinyllama-1.1b --smoke \\
        --requests 8 [--fog --thresh 0.3] [--device cpu]
    python -m repro_torch.launch.serve --registry DIR [--device cpu]

The LM mode serves ``--arch`` (``--smoke``: its reduced config) with fp32
weights drawn from a ``torch.Generator`` seeded with ``--seed``, through
``models/transformer.py`` and, with ``--fog``, ``models/fog_exit.py::
decode_step_fog``.  The registry mode is the forest plane: every tenant of
a :class:`~repro_torch.registry.ModelRegistry` behind one batcher, packed
replicas (device-resident slot state, one ``fused_fog`` launch per
dispatch), pipelined unless ``--sync``.

``--device`` (default ``cuda``; without a card that raises — pass ``cpu``
for the plain path) is where the replicas run.  ``--devices N`` serves
data-parallel over N replicas: on ``cuda`` they take the cards round robin
(several replicas on one card each get their own CUDA stream), on a named
device (``cpu``, ``cuda:1``) they all share it.  ``--max-queue`` /
``--shed-policy`` expose the admission-control knobs.
"""
from __future__ import annotations

import argparse
import contextlib
import copy
import time

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.configs import get_arch, smoke_config
from repro_torch.core.policy import BACKENDS, PRECISIONS, FogPolicy
from repro_torch.data.lm_data import DataConfig, batch_at_step
from repro_torch.models import transformer as T
from repro_torch.models.fog_exit import (decode_step_fog, grove_boundaries,
                                         lm_hop_energy)
from repro_torch.serve.governor import EnergyGovernor
from repro_torch.serve.scheduler import ContinuousBatcher, Request


def build_parser() -> argparse.ArgumentParser:
    """The serve CLI (a function so tests can assert the choices stay in
    sync with the engine's registries)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None,
                    help="LM architecture to serve (required unless "
                         "--registry selects forest serving)")
    ap.add_argument("--registry", default=None, metavar="DIR",
                    help="serve forest models from a ModelRegistry "
                         "directory instead of an LM: multi-tenant "
                         "(model, version, precision)-bucketed dispatch "
                         "through a byte-budgeted PackCache")
    ap.add_argument("--tenant", action="append", default=None,
                    help="registry tenant(s) to drive demo traffic at "
                         "(repeatable; default: every published tenant)")
    ap.add_argument("--cache-budget-mb", type=float, default=64.0,
                    help="PackCache byte budget for the packed tables "
                         "resident on each device (registry mode)")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=160)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--fog", action="store_true")
    ap.add_argument("--fog-backend", default="reference",
                    choices=list(BACKENDS),
                    help="engine backend for the exit gate (kernel-flavored "
                         "choices route the top-2 margin kernel; in "
                         "registry mode the forest backend, 'reference' "
                         "meaning 'fused')")
    ap.add_argument("--thresh", type=float, default=0.3)
    ap.add_argument("--fog-precision", default=None,
                    choices=list(PRECISIONS),
                    help="default FogPolicy precision stamped on the "
                         "batcher (forest-backed decode paths read it to "
                         "pick their packed tables; the LM layer-grove gate "
                         "has no forest tables and ignores it); requests "
                         "may override per-policy — the batcher dispatches "
                         "once per precision group")
    ap.add_argument("--hop-budget", type=int, default=None,
                    help="per-request grove budget (anytime decoding cap)")
    ap.add_argument("--energy-budget-nj", type=float, default=None,
                    help="serving SLO: rolling nJ/classification target — "
                         "installs an EnergyGovernor that walks a "
                         "threshold-tightening / hop-capping ladder when "
                         "the rolling estimate breaches the budget "
                         "(energy priced by the LM layer-grove FLOP proxy, "
                         "models/fog_exit.lm_hop_energy)")
    ap.add_argument("--device", default="cuda",
                    help="where the replicas run: 'cuda' (the default; "
                         "raises without a card), 'cuda:K' or 'cpu'")
    ap.add_argument("--devices", type=int, default=1,
                    help="data-parallel serving: N replicas, each with its "
                         "own copy of the model and a fixed span of the "
                         "slot batch (on 'cuda' the cards round robin, one "
                         "CUDA stream per replica)")
    ap.add_argument("--max-queue", type=int, default=None,
                    help="admission control: bound the request queue "
                         "(default unbounded)")
    ap.add_argument("--shed-policy", default="reject",
                    choices=["reject", "oldest"],
                    help="who is shed when the queue is full")
    ap.add_argument("--sync", action="store_true",
                    help="registry mode: synchronous packed step instead "
                         "of the default double-buffered pipeline (host "
                         "bookkeeping overlapped with device compute)")
    ap.add_argument("--telemetry-every", type=int, default=None,
                    help="registry mode: replay buffered telemetry every "
                         "k harvests instead of per step (default 8; the "
                         "LM decode path accounts inline and only "
                         "accepts 1)")
    ap.add_argument("--seed", type=int, default=0)
    return ap


def replica_devices(device: str, n: int) -> list[torch.device]:
    """``n`` replica devices for ``--device``: the cards round robin for
    ``cuda``, else ``device`` itself ``n`` times."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        cards = torch.cuda.device_count()
        return [torch.device("cuda", i % cards) for i in range(n)]
    return [dev] * n


def _splice_row(batch_leaf: torch.Tensor, row_leaf: torch.Tensor, slot: int,
                n_slots: int) -> torch.Tensor:
    """Write a 1-row prefill cache leaf into lane ``slot`` of a batched
    cache leaf (axis found by its ``n_slots`` extent), in place; returns
    the batched leaf."""
    for ax in range(batch_leaf.ndim):
        if batch_leaf.shape[ax] == n_slots and row_leaf.shape[ax] == 1:
            sl = [slice(None)] * batch_leaf.ndim
            sl[ax] = slice(slot, slot + 1)
            for sax in range(batch_leaf.ndim):
                if sax != ax and row_leaf.shape[sax] != batch_leaf.shape[sax]:
                    sl[sax] = slice(0, row_leaf.shape[sax])
            batch_leaf[tuple(sl)] = row_leaf.to(batch_leaf.dtype)
            return batch_leaf
    return batch_leaf


def _splice_tree(batch, row, slot: int, n_slots: int):
    """:func:`_splice_row` over every leaf of a cache tree."""
    if isinstance(batch, dict):
        return {k: _splice_tree(batch[k], row[k], slot, n_slots)
                for k in batch}
    if isinstance(batch, (list, tuple)):
        return type(batch)(_splice_tree(b, r, slot, n_slots)
                           for b, r in zip(batch, row))
    return _splice_row(batch, row, slot, n_slots)


def _serve_registry(args) -> dict:
    """Registry demo: N tenants' live forests behind one batcher, mixed
    per-request precisions, per-tenant energy governors when an SLO is
    given.  Feature rows are synthetic (the demo exercises the serving
    plane, not the datasets)."""
    from repro_torch.registry import ModelRegistry, PackCache
    from repro_torch.serve.dispatch import (DeviceDispatcher,
                                            ForestReplicaServer)
    from repro_torch.serve.governor import TenantLedger, default_ladder

    devices = replica_devices(args.device, args.devices)
    registry = ModelRegistry(args.registry)
    tenants = args.tenant or registry.tenants()
    if not tenants:
        raise SystemExit(f"registry {args.registry} has no tenants; "
                         "publish one with ModelRegistry.publish first")
    cache = PackCache(registry,
                      budget_bytes=int(args.cache_budget_mb * 2**20))
    pack0, extra0 = registry.load(tenants[0])
    n_features = int(extra0.get("n_features_in",
                                int(pack0.feature.max()) + 1))
    server = ForestReplicaServer(None, n_features,
                                 backend=args.fog_backend
                                 if args.fog_backend != "reference"
                                 else "fused",
                                 registry=registry, cache=cache,
                                 seed=args.seed)
    # the packed replica protocol: device-resident slot state + one launch
    # per dispatch, which is what makes the pipelined step safe
    dispatcher = DeviceDispatcher(server.packed_factory, devices)

    default_policy = FogPolicy(threshold=args.thresh,
                               hop_budget=args.hop_budget,
                               precision=args.fog_precision)
    ledger = None
    if args.energy_budget_nj is not None:
        ledger = TenantLedger()
        for t in tenants:
            model = server.energy_model(tenant=t)
            ledger.add(t, EnergyGovernor(
                default_ladder(default_policy, model,
                               args.energy_budget_nj),
                args.energy_budget_nj, model=model,
                window=max(args.slots * 4, 16)))
    batcher = ContinuousBatcher(args.slots, None, server.prefill, eos_id=-1,
                                default_policy=default_policy,
                                governor=ledger, dispatcher=dispatcher,
                                registry=registry,
                                max_queue=args.max_queue,
                                shed_policy=args.shed_policy,
                                pipeline=not args.sync,
                                telemetry_every=(args.telemetry_every
                                                 if args.telemetry_every
                                                 is not None else 8))
    rng = np.random.default_rng(args.seed)
    admitted = 0
    for rid in range(args.requests):
        t = tenants[rid % len(tenants)]
        admitted += batcher.submit(Request(
            rid=rid, prompt=rng.standard_normal(n_features), model=t,
            max_new_tokens=1))
    t0 = time.time()
    done = batcher.run()
    dt = time.time() - t0
    print(f"[serve] registry {args.registry}: {len(done)}/{admitted} "
          f"requests over {len(tenants)} tenants in {dt:.2f}s on "
          f"{len(devices)} replica(s) of {devices[0]}")
    for t in tenants:
        v = registry.live_version(t)
        st = registry.stats_for(t, v)
        print(f"  {t} v{v}: {st.n_events} events, "
              f"mean hops {st.mean_hops:.2f}"
              + (f", {st.mean_energy_nj:.3f} nJ/event"
                 if st.has_energy else ""))
    print(f"[serve] cache {cache.summary()}")
    if ledger is not None:
        print(f"[serve] ledger\n{ledger.summary()}")
    return {"batcher": batcher, "done": done, "registry": registry,
            "cache": cache, "server": server, "dispatcher": dispatcher,
            "seconds": dt}


def _serve_lm(ap, args) -> dict:
    """LM demo: ``--requests`` prompts of 24 tokens through the continuous
    batcher over the plain or FoG decode step."""
    if args.energy_budget_nj is not None and not args.fog:
        # without --fog the decode step reports no hop telemetry: the
        # governor would be a silent no-op, which is worse than an error
        ap.error("--energy-budget-nj requires --fog (the governor needs "
                 "the FoG decode path's hop telemetry)")
    if args.devices > 1 and args.slots % args.devices:
        ap.error(f"--slots {args.slots} must divide evenly over "
                 f"--devices {args.devices} (fixed per-device spans)")
    if args.telemetry_every is not None and args.telemetry_every != 1:
        ap.error("--telemetry-every > 1 needs the packed registry plane "
                 "(--registry DIR); the LM decode path accounts inline")

    cfg = smoke_config(args.arch) if args.smoke else get_arch(args.arch)
    if cfg.frontend:
        raise SystemExit(f"{cfg.name}: stub-frontend archs serve via "
                         "precomputed embeddings; use serve/decode.py directly")
    devices = replica_devices(args.device, args.devices)
    dev = devices[0]
    params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(
        args.seed), torch.float32, device=dev)

    default_policy = FogPolicy(threshold=args.thresh,
                               hop_budget=args.hop_budget,
                               backend=args.fog_backend,
                               precision=args.fog_precision)

    def decode_on(params_d, device, tokens, caches, lengths, policy):
        length = int(np.asarray(lengths).max())
        tk = torch.as_tensor(np.asarray(tokens)).to(device)
        if args.fog:
            logits, caches, hops = decode_step_fog(
                params_d, cfg, tk, caches, length, policy)
            return logits, caches, hops
        logits, caches = T.decode_step(params_d, cfg, tk, caches, length)
        return logits, caches, None

    def prompt_cache(params_d, prompt):
        _, c = T.prefill(params_d, cfg,
                         tokens=torch.as_tensor(np.asarray(prompt))[None]
                         .to(params_d.embed.device),
                         max_seq=args.max_seq)
        return c

    dispatcher = None
    if args.devices > 1:
        from repro_torch.serve.dispatch import DeviceDispatcher

        # one replica per entry of `devices`: the params once per device,
        # and the KV caches for the replica's span of slots — lanes never
        # migrate, so a prefill touches exactly one replica's cache
        states: dict[int, dict] = {}
        on_device = {dev: params}

        def factory(index, device, span):
            if device not in on_device:
                on_device[device] = copy.deepcopy(params).to(device)
            params_d = on_device[device]
            states[index] = {
                "caches": T.cache_init(cfg, span, args.max_seq,
                                       torch.float32, device=device),
                "params": params_d, "device": device}

            def decode(tokens, lengths, policy):
                st = states[index]
                logits, st["caches"], hops = decode_on(
                    st["params"], device, tokens, st["caches"], lengths,
                    policy)
                return logits, hops

            return decode

        dispatcher = DeviceDispatcher(factory, devices)
        span = args.slots // args.devices

        def prefill_fn(slot: int, prompt: np.ndarray) -> int:
            index = slot // span
            st = states[index]
            # on the replica's stream: its next decode reads these rows
            stream = dispatcher.streams[index]
            with (torch.cuda.stream(stream) if stream is not None
                  else contextlib.nullcontext()):
                c = prompt_cache(st["params"], prompt)
                st["caches"] = _splice_tree(st["caches"], c, slot % span,
                                            span)
            return len(prompt)

        decode_fn = None
    else:
        state = {"caches": T.cache_init(cfg, args.slots, args.max_seq,
                                        torch.float32, device=dev)}

        def prefill_fn(slot: int, prompt: np.ndarray) -> int:
            c = prompt_cache(params, prompt)
            state["caches"] = _splice_tree(state["caches"], c, slot,
                                           args.slots)
            return len(prompt)

        def decode_fn(tokens, lengths, policy):
            # policy: the batcher's per-lane assembly of the slots' QoS
            # contracts
            logits, state["caches"], hops = decode_on(
                params, dev, tokens, state["caches"], lengths, policy)
            return logits, hops

    governor = None
    if args.energy_budget_nj is not None:
        model = lm_hop_energy(cfg)
        t = args.thresh
        # quality-descending LM ladder: tighten the exit threshold, then
        # cap hops at whatever the budget affords (int8 rungs are moot —
        # the layer-grove gate has no packed forest tables).  An explicit
        # --hop-budget stays a ceiling on every rung
        cap = model.hops_within(args.energy_budget_nj * 1e3)
        if args.hop_budget is not None:
            cap = min(cap, args.hop_budget)
        ladder = [default_policy,
                  default_policy.replace(threshold=t * 0.5),
                  default_policy.replace(threshold=t * 0.25),
                  default_policy.replace(threshold=t * 0.25,
                                         hop_budget=cap)]
        governor = EnergyGovernor(ladder, args.energy_budget_nj,
                                  model=model, window=max(args.slots * 4, 16))
    batcher = ContinuousBatcher(args.slots, decode_fn, prefill_fn, eos_id=-1,
                                default_policy=default_policy,
                                governor=governor, dispatcher=dispatcher,
                                max_queue=args.max_queue,
                                shed_policy=args.shed_policy)
    dcfg = DataConfig(cfg.vocab_size, 32, 8, seed=args.seed + 7)
    admitted = 0
    for rid in range(args.requests):
        prompt = batch_at_step(dcfg, rid)["tokens"][0, :24] % cfg.vocab_size
        admitted += batcher.submit(Request(rid=rid, prompt=prompt,
                                           max_new_tokens=args.max_new))
    t0 = time.time()
    done = batcher.run()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.time() - t0
    total_tokens = sum(len(r.generated) for r in done)
    print(f"[serve] {len(done)}/{admitted} requests, {total_tokens} tokens "
          f"in {dt:.1f}s ({total_tokens / dt:.1f} tok/s)"
          + (f" on {args.devices} devices" if args.devices > 1 else ""))
    if batcher.stats.n_shed:
        print(f"[serve] admission shed {batcher.stats.n_shed}/"
              f"{batcher.stats.n_offered} "
              f"({100 * batcher.stats.shed_rate:.1f}%)")
    g = len(grove_boundaries(cfg))
    if args.fog:
        for r in sorted(done, key=lambda r: r.rid):
            h = np.asarray(r.hops, np.float64)
            print(f"  req {r.rid}: groves/token {h.mean():.2f} "
                  f"(flops frac {h.mean() / g:.2f})")
        print(f"[serve] fleet {batcher.stats.summary(g)}")
        if governor is not None:
            print(f"[serve] governor {governor.summary()}")
    return {"batcher": batcher, "done": done, "params": params, "cfg": cfg,
            "seconds": dt, "tokens": total_tokens, "n_groves": g,
            "governor": governor}


def main(argv=None) -> dict:
    """Run the CLI; returns what it served (the batcher, the completed
    requests and the mode's objects) for callers that check it."""
    ap = build_parser()
    args = ap.parse_args(argv)
    resolve_device(args.device)
    if args.registry is not None:
        return _serve_registry(args)
    if args.arch is None:
        ap.error("--arch is required (or pass --registry DIR for "
                 "forest-registry serving)")
    return _serve_lm(ap, args)


if __name__ == "__main__":
    main()

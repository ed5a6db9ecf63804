"""Shared set-up for the parity tests of the PyTorch port against the
reference JAX package: matching configurations in both packages, bridged
weights, and numpy inputs from a seed.  JAX stays on the CPU."""

from __future__ import annotations

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs.base import ArchConfig as JArchConfig
from repro.configs.base import BlockCfg as JBlockCfg
from repro.core.spls import SPLSConfig as JSPLSConfig
from repro.models import init_params as jax_init_params
from repro.serving import (PagedServingEngine as JEngine, Request as JRequest,
                           ServeConfig as JServe,
                           ServingEngine as JDenseEngine)
from repro_torch.configs.base import ArchConfig as TArchConfig
from repro_torch.configs.base import BlockCfg as TBlockCfg
from repro_torch.core.spls import SPLSConfig as TSPLSConfig
from repro_torch.serve_batch import demo_config
from repro_torch.serving import (PagedServingEngine as TEngine,
                                 Request as TRequest, ServeConfig as TServe,
                                 ServingEngine as TDenseEngine)
from repro_torch.weights import params_from_jax

jax.config.update("jax_platform_name", "cpu")

SPLS = dict(enabled=True, k_ratio=0.12, s_threshold=0.6, f_threshold=2,
            window=4, causal=True)

# small causal configurations: MHA, GQA (G = 2) with qk-norm, a window
CONFIGS = {
    "mha": dict(),
    "gqa_qknorm": dict(n_kv_heads=2, qk_norm=True),
    "gqa_window_softcap": dict(n_kv_heads=2, window=12, attn_softcap=20.0),
}


def cfg_pair(kind: str = "mha", spls: dict = None, **kw):
    """(reference ArchConfig, port ArchConfig) with equal fields."""
    over = dict(CONFIGS[kind])
    over.update(kw)
    window = over.pop("window", None)
    base = dict(name=f"parity-{kind}", n_layers=2, d_model=64, n_heads=4,
                n_kv_heads=4, head_dim=16, d_ff=128, vocab_size=128,
                ffn_activation="gelu_mlp", remat=False, causal=True)
    base.update(over)
    sp = dict(SPLS)
    sp.update(spls or {})
    jc = JArchConfig(period=(JBlockCfg(window=window),),
                     spls=JSPLSConfig(**sp), **base)
    tc = TArchConfig(period=(TBlockCfg(window=window),),
                     spls=TSPLSConfig(**sp), **base)
    return jc, tc


_PARAMS = {}


def arch_pair(arch_id: str, spls: dict = None, **kw):
    """(reference, port) smoke configs of a registry architecture, remat
    off, with ``kw`` replaced in both and SPLS turned on with ``spls``'s
    fields."""
    from repro.configs.registry import get_config as jget
    from repro_torch.configs.registry import get_config as tget
    jc = dataclasses.replace(jget(arch_id).smoke(), remat=False, **kw)
    tc = dataclasses.replace(tget(arch_id).smoke(), remat=False, **kw)
    if spls is not None:
        jc = dataclasses.replace(jc, spls=JSPLSConfig(**spls))
        tc = dataclasses.replace(tc, spls=TSPLSConfig(**spls))
    return jc, tc


def params_pair(jc, seed: int = 0, jit: bool = False):
    """(reference params, the same weights as port tensors on the CPU).
    ``jit`` draws the reference's weights under ``jax.jit``: one compile in
    place of thousands of eager ops, for the registry's smoke forms."""
    key = (repr(jc), seed, jit)  # a config's microbatch dict is unhashable
    if key not in _PARAMS:
        init = lambda k: jax_init_params(jc, k)
        jp = (jax.jit(init) if jit else init)(jax.random.PRNGKey(seed))
        tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
        _PARAMS[key] = (jp, tp)
    return _PARAMS[key]


def t(a) -> torch.Tensor:
    """numpy / jax array -> CPU tensor (copied)."""
    return torch.from_numpy(np.array(a, copy=True))


def n(x) -> np.ndarray:
    """tensor or jax array -> numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


_DEMO_PARAMS = {}


def demo_pair(spls: bool, k_ratio: float, s_threshold: float):
    """(reference config, port config, reference params, port params) of
    the ``serve-demo`` model of ``repro_torch.serve_batch``."""
    tc = demo_config(spls, k_ratio, s_threshold)
    sp = dataclasses.asdict(tc.spls)
    jc = JArchConfig(
        name=tc.name, n_layers=tc.n_layers, d_model=tc.d_model,
        n_heads=tc.n_heads, n_kv_heads=tc.n_kv_heads, head_dim=tc.head_dim,
        d_ff=tc.d_ff, vocab_size=tc.vocab_size,
        period=(JBlockCfg(mixer="attn"),), remat=False,
        spls=JSPLSConfig(**sp))
    key = (spls, k_ratio, s_threshold)
    if key not in _DEMO_PARAMS:
        jp = jax_init_params(jc, jax.random.PRNGKey(0))
        _DEMO_PARAMS[key] = (
            jp, params_from_jax(jax.tree.map(np.asarray, jp), device="cpu"))
    return (jc, tc) + _DEMO_PARAMS[key]


def serve_both(jc, tc, jp, tp, prompts, kw, max_new=4):
    """Serve the prompts through both packages' paged engines with the same
    ``ServeConfig`` fields; ``[(reference engine, outputs), (port engine,
    outputs)]``."""
    out = []
    for Engine, Req, Serve, cfg, params, extra in (
            (JEngine, JRequest, JServe, jc, jp, {}),
            (TEngine, TRequest, TServe, tc, tp, {"device": "cpu"})):
        eng = Engine(cfg, params, Serve(**kw), **extra)
        reqs = [Req(rid=i, prompt=(jnp.asarray(p) if Engine is JEngine
                                   else p), max_new_tokens=max_new)
                for i, p in enumerate(prompts)]
        for r in reqs:
            eng.submit(r)
        eng.run_until_drained(max_ticks=2000)
        assert all(r.done for r in reqs)
        out.append((eng, [r.output for r in reqs]))
    return out


# the SPLS knobs of the serving launcher (``launch.serve --spls``)
LAUNCH_SPLS = dict(enabled=True, k_ratio=0.25, s_threshold=0.6,
                   f_threshold=2, window=4, causal=True)


def family_prompts(vocab, lengths=(20, 13, 20)):
    r = np.random.default_rng(11)
    return [r.integers(0, vocab, L).astype(np.int32) for L in lengths]


def dense_engines_agree(arch_id, spls):
    """Three requests through two slots: admission into a freed slot,
    ragged prompts, batched decode with an inactive row."""
    jc, tc = arch_pair(arch_id, spls=LAUNCH_SPLS if spls else None)
    jp, tp = params_pair(jc, jit=True)
    kw = dict(n_slots=2, max_len=32, attn_backend="pallas_flash")
    jeng = JDenseEngine(jc, jp, JServe(**kw))
    teng = TDenseEngine(tc, tp, TServe(**kw), device="cpu")
    prompts = family_prompts(jc.vocab_size)
    jreqs = [JRequest(rid=i, prompt=jnp.asarray(p), max_new_tokens=4 + i)
             for i, p in enumerate(prompts)]
    treqs = [TRequest(rid=i, prompt=p, max_new_tokens=4 + i)
             for i, p in enumerate(prompts)]
    for eng, reqs in ((jeng, jreqs), (teng, treqs)):
        for q in reqs:
            eng.submit(q)
        done = eng.run_until_drained(max_ticks=200)
        assert len(done) == len(reqs) and all(q.done for q in reqs)
    assert [q.output for q in treqs] == [q.output for q in jreqs]


def unrolled_scan(f, init, xs):
    """``lax.scan`` as a Python loop (its ``ys`` unused): traced once per
    period, so the reference's block planner is called once per layer, in
    order."""
    carry = init
    for i in range(jax.tree.leaves(xs)[0].shape[0]):
        carry, _ = f(carry, jax.tree.map(lambda a: a[i], xs))
    return carry, None


def record_port_plans(monkeypatch) -> list:
    """From now on the port's block planner appends each plan it builds
    to the returned list."""
    from repro_torch.models import blocks as tblocks
    plans, build = [], tblocks.build_block_plan

    def record(cfg, p, xn):
        plan = build(cfg, p, xn)
        plans.append(plan)
        return plan

    monkeypatch.setattr(tblocks, "build_block_plan", record)
    return plans


def feed_reference_plans(monkeypatch, plans: list) -> None:
    """From now on the reference's block planner returns ``plans`` in
    order (its period scan unrolled), so both packages run one plan: the
    packages' plans differ at near-ties of the predicted scores."""
    from repro.models import blocks as jblocks
    feed = iter(plans)
    monkeypatch.setattr(jblocks, "build_block_plan", lambda cfg, p, xn:
                        jax.tree.map(lambda a: jnp.asarray(n(a)),
                                     next(feed)))
    monkeypatch.setattr(jax.lax, "scan", unrolled_scan)


@contextlib.contextmanager
def fake_world(world: int):
    """The default process group over the ``fake`` backend at ``world``
    ranks in this one process (rank 0), destroyed on exit so no later test
    sees it."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", rank=0, world_size=world,
                            store=FakeStore())
    try:
        yield
    finally:
        dist.destroy_process_group()


def mesh_stand_in(shape, axes):
    """What the reference's sharding rules read of a ``jax.sharding.Mesh``
    (``axis_names``, ``devices.shape``), without its devices."""
    import types
    return types.SimpleNamespace(axis_names=tuple(axes),
                                 devices=np.empty(shape, dtype=object))

"""Step builders shared by the launcher's tools, the dry run and the
tests (``repro/launch/steps.py``).

Each builder returns a plain closure.  Every call builds a fresh context
(``make_context(ring, seed=seed, collapse=collapse, device=device)``), so
a call's PRF counters start from zero and a repeated call with the same
inputs opens the same words, as a JAX retrace replays them; the abort flag
is returned with the outputs.  ``trident=False`` runs the PlainEngine
(float64) and never aborts.  Nothing is compiled: the port runs eagerly.
"""
from __future__ import annotations

from ..core.context import make_context
from ..core.ring import RING64, Ring
from ..nn import model as M
from ..nn.engine import PlainEngine, TridentEngine


def _engine(ring, trident, seed, collapse, nonlinear, device):
    if not trident:
        return None, PlainEngine(device=device)
    ctx = make_context(ring, seed=seed, collapse=collapse, device=device)
    return ctx, TridentEngine(ctx, nonlinear=nonlinear)


def make_train_step(cfg: M.ModelConfig, ring: Ring = RING64,
                    trident: bool = True, lr: float = 2.0 ** -6,
                    seed: int = 0, collapse: bool = False,
                    nonlinear: str = "garbled", device=None):
    def train_step(params, ids, labels, frontend_embs=None,
                   enc_inputs=None):
        ctx, eng = _engine(ring, trident, seed, collapse, nonlinear, device)
        new_params, loss, _ = M.train_step(
            eng, cfg, params, ids, labels, lr=lr,
            frontend_embs=frontend_embs, enc_inputs=enc_inputs)
        return new_params, loss, ctx is not None and ctx.abort_flag()

    return train_step


def make_prefill_step(cfg: M.ModelConfig, ring: Ring = RING64,
                      trident: bool = True, seed: int = 0,
                      collapse: bool = False, long_ctx: bool = False,
                      nonlinear: str = "garbled", device=None):
    def prefill_step(params, ids, frontend_embs=None, enc_inputs=None):
        ctx, eng = _engine(ring, trident, seed, collapse, nonlinear, device)
        logits, caches = M.serve_prefill(
            eng, cfg, params, ids, frontend_embs=frontend_embs,
            enc_inputs=enc_inputs, long_ctx=long_ctx)
        return logits, caches, ctx is not None and ctx.abort_flag()

    return prefill_step


def make_decode_step(cfg: M.ModelConfig, ring: Ring = RING64,
                     trident: bool = True, seed: int = 0,
                     collapse: bool = False, long_ctx: bool = False,
                     pos: int = 0, nonlinear: str = "garbled", device=None):
    def decode_step(params, ids_last, caches):
        ctx, eng = _engine(ring, trident, seed, collapse, nonlinear, device)
        logits, new_caches = M.serve_decode(
            eng, cfg, params, ids_last, caches, pos=pos, long_ctx=long_ctx)
        return logits, new_caches, ctx is not None and ctx.abort_flag()

    return decode_step

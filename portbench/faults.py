"""Faults planted in the program underneath a run, to see the comparison
fail: each patches one function of ``repro_torch.nn.model`` and returns
the function that takes the patch out again.

- ``unchanged``: the training step returns its state (weights and
  optimizer state) unchanged;
- ``half_batch``: the loss gradient keeps half of the labelled positions
  and takes the mean over those (the rest of the batch left out);
- ``token``: a served token is altered where it is produced (the prefill's
  and each decode step's largest logit handed on as the next id's);
- ``stale_cache``: a decode step returns the caches it was given.

The exchange between chips cannot be left out: every cell runs on one
card, in one process.
"""
from __future__ import annotations


def plant(name: str):
    import torch
    from repro_torch.nn import model as M
    if name == "unchanged":
        orig = M.train_step

        def train_step(eng, cfg, params, *args, **kw):
            _, loss, _ = orig(eng, cfg, params, *args, **kw)
            return params, loss, kw.get("opt_state")
        M.train_step = train_step
    elif name == "half_batch":
        orig = M.loss_head

        def loss_head(eng, cfg, logits, labels, n_front=0):
            loss, dl = orig(eng, cfg, logits, labels, n_front)
            s = eng.shape_of(dl)[1]
            keep = torch.zeros((1, s, 1), dtype=torch.int64)
            keep[:, n_front:n_front + (s - n_front) // 2] = 2
            return loss, eng.mask_public(dl, keep.to(eng.ctx.device)
                                         if hasattr(eng, "ctx") else keep)
        M.loss_head = loss_head
    elif name == "token":
        orig = M.serve_prefill, M.serve_decode

        def shifted(fn):
            def call(eng, cfg, *args, **kw):
                logits, caches = fn(eng, cfg, *args, **kw)
                best = eng.to_plain(logits).reshape(-1).argmax()
                bump = torch.zeros(eng.shape_of(logits), dtype=torch.float64)
                bump.view(-1)[(int(best) + 1) % cfg.vocab] = 1e3
                return eng.add_public(logits, bump.to(_dev(eng))), caches
            return call
        M.serve_prefill, M.serve_decode = shifted(orig[0]), shifted(orig[1])
    elif name == "stale_cache":
        orig = M.serve_decode

        def serve_decode(eng, cfg, params, ids_last, caches, pos, **kw):
            logits, _ = orig(eng, cfg, params, ids_last, caches, pos, **kw)
            return logits, caches
        M.serve_decode = serve_decode
    else:
        raise ValueError(f"no fault {name!r}")

    def remove():
        if name in ("token",):
            M.serve_prefill, M.serve_decode = orig
        elif name == "unchanged":
            M.train_step = orig
        elif name == "half_batch":
            M.loss_head = orig
        else:
            M.serve_decode = orig
    return remove


def _dev(eng):
    return eng.ctx.device if hasattr(eng, "ctx") else eng.device

"""Serving traffic: a closed loop of clients at batch 1, each sending its
next request when the last is answered.

Traffic file keys: ``prompt_ids`` (the prompt lengths in text ids, sent in
this fixed cycle, behind the configuration's frontend embeddings),
``new_tokens`` (greedy tokens a request), ``trace_requests`` (the requests
a traced run profiles), ``check_requests`` (the most requests the
reference checks; a sample drawn from the seed, the longest prompt in it).

Request i draws its ids and its image's patch embeddings from the seed
(``lm.feed_generator``).  A request shares its patches, runs
``serve_prefill``, opens the last position's logits to the host and takes
the largest as its first token (time to first token), then runs
``serve_decode`` through the caches for each further token, opening each
step's logits (time a token: all decode time over all decoded tokens).
Set-up serves one request of each prompt length.  The window sends
whole cycles of the prompt lengths until ``--seconds`` have passed; a
cycle started inside it counts whole, so every window serves the same
mix.  After it the program's state is freed and the reference
runs once over each checked prompt with its served tokens.
"""
from __future__ import annotations

import time

import torch

from portbench import compare, flops, lm
from portbench.trace import Tracer, ring_matmul_spans


def request(cfg: dict, traffic: dict, seed: int, i: int, device):
    """Request i's (ids, patch embeddings)."""
    s = lm.sizes(cfg)
    cycle = traffic["prompt_ids"]
    gen = lm.feed_generator(seed, i, device)
    ids = torch.randint(0, s["v"], (1, cycle[i % len(cycle)]), generator=gen,
                        device=device)
    return ids, lm.frontend(cfg, gen, 1, device)


class Program:
    """The program's serving path as the window drives it."""

    def __init__(self, cfg, traffic, seed, device, ring_bits=None):
        from repro_torch.nn import model as M
        self.M, self.cfg, self.traffic = M, cfg, traffic
        self.seed, self.device = seed, device
        self.mcfg = lm.model_config(cfg)
        self.eng = lm.engine(cfg, seed, device, ring_bits)
        w = lm.make_weights(cfg, seed, device)
        self.params = M.params_to_engine(self.eng, lm.program_tree(cfg, w))
        del w

    def _open(self, logits) -> torch.Tensor:
        return self.eng.declassify(logits).reshape(-1).cpu()

    def serve(self, i: int, tracer=None, force=None) -> dict:
        """Request i: its tokens, each served position's opened logits,
        time to first token and decode times.  `force`: tokens fed instead
        of the served ones (the control's teacher forcing)."""
        tracer = tracer or Tracer(False)
        ids, front = request(self.cfg, self.traffic, self.seed, i,
                             self.device)
        n_front = lm.sizes(self.cfg)["front"]
        kept = []
        t0 = time.perf_counter()
        with tracer.phase_span("prefill"):
            fe = self.eng.from_plain(front)
            logits, caches = self.M.serve_prefill(self.eng, self.mcfg,
                                                  self.params, ids,
                                                  frontend_embs=fe)
            lg = self._open(logits)
        tok = [int(lg.argmax())]
        ttft = time.perf_counter() - t0
        kept.append(lg)
        decode = []
        pos = n_front + ids.shape[1]
        for j in range(1, self.traffic["new_tokens"]):
            t = time.perf_counter()
            feed = tok[-1] if force is None else force[j - 1]
            with tracer.phase_span("decode"):
                last = torch.tensor([[feed]], device=self.device)
                logits, caches = self.M.serve_decode(
                    self.eng, self.mcfg, self.params, last, caches, pos)
                lg = self._open(logits)
            tok.append(int(lg.argmax()))
            kept.append(lg)
            decode.append(time.perf_counter() - t)
            pos += 1
        return {"i": i, "prompt": ids.shape[1], "tokens": tok, "ttft": ttft,
                "decode": decode, "logits": kept}

    def online_bits(self) -> int:
        return self.eng.ctx.tally.totals()["online"]["bits"]

    def free(self):
        self.params = self.eng = None


def warm_up(p: Program, seed_base: int = 1 << 20) -> None:
    """One request of each prompt length, outside the run's own indices."""
    for k in range(len(p.traffic["prompt_ids"])):
        p.serve(seed_base * len(p.traffic["prompt_ids"]) + k)


def window(p: Program, seconds: float) -> dict:
    """Whole cycles of the prompt lengths until `seconds` have passed (a
    cycle started inside the window counts whole, with its time), so every
    window serves the same mix."""
    cycle = len(p.traffic["prompt_ids"])
    bits0 = p.online_bits()
    done, t0 = [], time.perf_counter()
    while time.perf_counter() - t0 < seconds or len(done) % cycle:
        done.append(p.serve(len(done)))
    t1 = time.perf_counter()
    dec = [d for r in done for d in r["decode"]]
    return {"requests": done, "seconds": t1 - t0,
            "ttft_s": sum(r["ttft"] for r in done) / len(done),
            "tpot_ms": 1e3 * sum(dec) / len(dec),
            "online_bits": p.online_bits() - bits0}


def traced(p: Program, units: int) -> tuple:
    """`units` requests under the profiler, with spans around each
    prefill, each decode step and each ring matmul."""
    tracer = Tracer(True)
    bits = {"prefill": 0, "decode": 0}
    orig = {"prefill": p.M.serve_prefill, "decode": p.M.serve_decode}

    def counted(phase):
        def call(*args, **kw):
            b0 = p.online_bits()
            out = orig[phase](*args, **kw)
            bits[phase] += p.online_bits() - b0
            return out
        return call

    p.M.serve_prefill, p.M.serve_decode = counted("prefill"), \
        counted("decode")
    done = []
    try:
        with ring_matmul_spans(tracer, bits) as bound:
            tracer.start()
            with tracer.span("window"):
                for i in range(units):
                    done.append(p.serve(i, tracer))
            summary = tracer.stop()
    finally:
        p.M.serve_prefill, p.M.serve_decode = orig["prefill"], \
            orig["decode"]
    s = lm.sizes(p.cfg)
    pre_pos = sum(s["front"] + r["prompt"] for r in done)
    n_dec = sum(len(r["decode"]) for r in done)
    counts = {
        "positions": {"prefill": pre_pos},
        "tokens": {"decode": n_dec},
        "online_bits": bits,
        "plain_ops": {
            "prefill": sum(flops.prefill_ops(s, s["front"] + r["prompt"])
                           for r in done),
            "decode": sum(flops.decode_ops(s, s["front"] + r["prompt"] + j)
                          for r in done for j in range(len(r["decode"])))},
        "ring_matmul_bound_s": bound,
    }
    return summary, counts, done


def check_sample(traffic: dict, done: list, seed: int) -> list:
    """The requests the reference checks: all, or a sample drawn from the
    seed that holds a request of the longest prompt."""
    n = traffic["check_requests"]
    if len(done) <= n:
        return done
    gen = torch.Generator().manual_seed(seed % (1 << 63))
    longest = max(range(len(done)), key=lambda k: done[k]["prompt"])
    rest = [k for k in torch.randperm(len(done), generator=gen).tolist()
            if k != longest][:n - 1]
    return [done[k] for k in sorted([longest] + rest)]


def reference_gaps(cfg, traffic, seed, device, served) -> tuple:
    """Per checked request, the gap of each served token at its position
    in one causal pass of the reference over the prompt and the tokens,
    and the largest gap between the served logits and the reference's:
    ([gaps of each request], largest logit error)."""
    ref = lm.reference(cfg)
    fx = ref.FixedPoint(cfg["program"]["frac_bits"])
    rc = lm.ref_cfg(cfg)
    params = ref.encode(fx, lm.reference_tree(
        cfg, lm.make_weights(cfg, seed, device)))
    out, err = [], 0.0
    for r in served:
        ids, front = request(cfg, traffic, seed, r["i"], device)
        toks = torch.tensor([r["tokens"]], device=device)
        full = torch.cat([ids, toks[:, :-1]], dim=1)
        logits = ref.served_logits(fx, params, rc, full, front)
        at = logits[0, ids.shape[1] - 1:]
        out.append(compare.token_gaps(at, r["tokens"]))
        served = torch.stack(r["logits"]).to(at.device, torch.float64)
        err = max(err, float((served - at).abs().max()))
        del logits, at, served
    return out, err


def run(c: dict, seed: int, seconds: float, trace: bool, device,
        t_start: float) -> dict:
    cfg, traffic = c["config"], c["traffic"]
    p = Program(cfg, traffic, seed, device)
    warm_up(p)
    summary = counts = w = None
    t_set = time.perf_counter()
    if trace:
        summary, counts, done = traced(p, traffic["trace_requests"])
    else:
        w = window(p, seconds)
        done = w["requests"]
    setup_s = t_set - t_start
    peak = torch.cuda.max_memory_allocated() \
        if torch.device(device).type == "cuda" else 0
    p.free()
    del p
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    served = check_sample(traffic, done, seed)
    gaps, err = reference_gaps(cfg, traffic, seed, device, served)
    return {"numbers": compare.serve_numbers(gaps, err),
            "attempted": len(done), "failed": 0, "peak": peak,
            "trace": summary, "counts": counts, "setup_s": setup_s,
            "values": None if w is None else {
                "ttft_s": w["ttft_s"], "tpot_ms": w["tpot_ms"],
                "setup_s": setup_s},
            "window": None if w is None else {
                k: v for k, v in w.items() if k != "requests"}}

"""Training traffic: back-to-back secure training steps of one model.

Traffic file keys: ``ids`` (text ids a row, behind the configuration's
frontend embeddings), ``batch``, ``lr`` and ``beta`` of Polyak momentum
(the port's ``train.optim.Momentum``), ``check_steps`` (the steps of
set-up that the reference follows), ``trace_steps`` (the steps a traced
run profiles).

Each step i draws its own rows from the seed (``lm.feed_generator``):
ids + 1 tokens of the vocabulary, the ids and their next tokens as labels,
and the image's patch embeddings, shared as the step's input.  Set-up
builds one engine and one parameter tree, drives it through the first
``check_steps`` steps by ``train_step`` itself (the window's call and
feed), reads the program's state after the first and the last of them,
then hands the same tree and optimizer state to the window.  The first
gradient is read as the optimizer got it, from its buffer after one step
(m1 = beta 0 + g).  The window runs whole steps until ``--seconds`` have
passed; a step that starts inside it counts whole, with
its time.  After the window the program's state is freed and the
reference follows the checked steps from the same weights and rows.
"""
from __future__ import annotations

import time

import torch

from portbench import compare, flops, lm
from portbench.trace import Tracer, ring_matmul_spans


def batch(cfg: dict, traffic: dict, seed: int, i: int, device):
    """Step i's (ids, labels, patch embeddings)."""
    s = lm.sizes(cfg)
    gen = lm.feed_generator(seed, i, device)
    b, n = traffic["batch"], traffic["ids"]
    tok = torch.randint(0, s["v"], (b, n + 1), generator=gen, device=device)
    return tok[:, :-1], tok[:, 1:], lm.frontend(cfg, gen, b, device)


def positions(cfg: dict, traffic: dict) -> int:
    return traffic["batch"] * (traffic["ids"] + lm.sizes(cfg)["front"])


class Program:
    """The program's training step as the window drives it."""

    def __init__(self, cfg, traffic, seed, device, ring_bits=None):
        from repro_torch.nn import model as M
        self.M, self.cfg, self.traffic = M, cfg, traffic
        self.seed, self.device = seed, device
        self.mcfg = lm.model_config(cfg)
        self.eng = lm.engine(cfg, seed, device, ring_bits)
        w0 = lm.make_weights(cfg, seed, device)
        self.params = M.params_to_engine(self.eng, lm.program_tree(cfg, w0))
        del w0               # drawn again from the seed where it is read
        from repro_torch.train.optim import Momentum
        self.opt = Momentum(lr=traffic["lr"], beta=traffic["beta"])
        self.opt_state = None
        self.steps = 0
        self.losses = []

    def step(self, tracer=None) -> float:
        ids, labels, front = batch(self.cfg, self.traffic, self.seed,
                                   self.steps, self.device)
        tracer = tracer or Tracer(False)
        with tracer.phase_span("step"):
            fe = self.eng.from_plain(front)
            self.params, loss, self.opt_state = self.M.train_step(
                self.eng, self.mcfg, self.params, ids, labels,
                frontend_embs=fe, optimizer=self.opt,
                opt_state=self.opt_state)
            loss = float(loss)
            lm.sync(self.device)
        self.steps += 1
        self.losses.append(loss)
        return loss

    def change_norms(self, fx) -> dict:
        """{leaf part: ‖w - q(w0)‖} of the program's weights now."""
        w0 = lm.reference_parts(self.cfg, lm.reference_tree(
            self.cfg, lm.make_weights(self.cfg, self.seed, self.device)))
        return {k: float(torch.linalg.vector_norm(x - fx.q(w0[k])))
                for k, x in lm.program_parts(self.cfg, self.eng,
                                             self.params)}

    def first_gradient_norms(self) -> dict:
        """{leaf part: ‖g‖} of the gradient as the optimizer got it, from
        its buffer after one step (none where the step left no state)."""
        if self.opt_state is None:
            return dict.fromkeys(lm.part_names(self.cfg), 0.0)
        return {k: float(torch.linalg.vector_norm(x))
                for k, x in lm.program_parts(self.cfg, self.eng,
                                             self.opt_state)}

    def check_readings(self) -> dict:
        """Drive the checked steps; the losses, the first gradient's norms
        and the change's norms, each leaf by leaf."""
        fx = lm.reference(self.cfg).FixedPoint(
            self.cfg["program"]["frac_bits"])
        n = self.traffic["check_steps"]
        out = {}
        for i in range(n):
            self.step()
            if i == 0:
                t = time.perf_counter()
                out["grad"] = self.first_gradient_norms()
                out["read_s"] = time.perf_counter() - t
        t = time.perf_counter()
        out["change"] = self.change_norms(fx)
        out["read_s"] += time.perf_counter() - t
        out["losses"] = list(self.losses[:n])
        return out

    def online_bits(self) -> int:
        return self.eng.ctx.tally.totals()["online"]["bits"]

    def free(self):
        self.params = self.eng = self.opt_state = None


def reference_readings(cfg, traffic, seed, device, noise=None,
                       noise_units=1.0) -> dict:
    """The reference through the checked steps: losses, the first
    gradient's norms as the optimizer got it (from its state after one
    step) and the change's norms after the last.  `noise`, `noise_units`:
    the truncations' zero-mean noise (``FixedPoint``)."""
    ref = lm.reference(cfg)
    fx = ref.FixedPoint(cfg["program"]["frac_bits"], noise, noise_units)
    rc = lm.ref_cfg(cfg)
    p0 = ref.encode(fx, lm.reference_tree(cfg, lm.make_weights(cfg, seed,
                                                               device)))
    params, losses, out, m = p0, [], {}, None
    for i in range(traffic["check_steps"]):
        ids, labels, front = batch(cfg, traffic, seed, i, device)
        loss, g = ref.grads(fx, params, rc, ids, labels, front)
        params, m = ref.momentum(fx, params, m, g, traffic["lr"],
                                 traffic["beta"])
        del g
        losses.append(loss)
        if i == 0:
            out["grad"] = _norms(cfg, m)
    out["change"] = _norms(cfg, params, p0)
    out["losses"] = losses
    return out


def _norms(cfg, a, b=None) -> dict:
    """{part: ‖a - b‖} (‖a‖ without b) of reference-layout trees."""
    pa = lm.reference_parts(cfg, a)
    pb = None if b is None else lm.reference_parts(cfg, b)
    return {k: float(torch.linalg.vector_norm(
        x if pb is None else x - pb[k])) for k, x in pa.items()}


def numbers(cfg: dict, prog: dict, refr: dict) -> dict:
    lay = lm.layout(cfg)
    return compare.train_numbers(prog["grad"], refr["grad"], prog["change"],
                                 refr["change"], lay.group,
                                 lay.CHANGE_NOT_COMPARED)


def traced(p: Program, units: int) -> tuple:
    """`units` steps under the profiler, with spans around each step, the
    optimizer's update and each ring matmul; (trace summary, counts)."""
    tracer = Tracer(True)
    update_s = []
    orig_upd = p.opt.update

    def update(*args, **kw):
        lm.sync(p.device)
        t = time.perf_counter()
        with tracer.span("update"):
            out = orig_upd(*args, **kw)
            lm.sync(p.device)
        update_s.append(time.perf_counter() - t)
        return out

    p.opt.update = update
    bits0 = p.online_bits()
    try:
        with ring_matmul_spans(tracer, ["step"]) as bound:
            tracer.start()
            with tracer.span("window"):
                for _ in range(units):
                    p.step(tracer)
            summary = tracer.stop()
    finally:
        del p.opt.update
    s = lm.sizes(p.cfg)
    pos = units * positions(p.cfg, p.traffic)
    labels = units * p.traffic["batch"] * p.traffic["ids"]
    counts = {
        "positions": {"step": pos},
        "online_bits": {"step": p.online_bits() - bits0},
        "plain_ops": {"step": units * flops.train_step_ops(
            s, positions(p.cfg, p.traffic) // p.traffic["batch"],
            p.traffic["ids"]) * p.traffic["batch"]},
        "labels": labels,
        "ring_matmul_bound_s": bound,
        "update_s": update_s,
    }
    return summary, counts


def window(p: Program, seconds: float) -> dict:
    """Whole steps until `seconds` have passed (a step started inside the
    window counts whole, with its time)."""
    bits0 = p.online_bits()
    n, t0 = 0, time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        p.step()
        n += 1
    t1 = time.perf_counter()
    pos = n * positions(p.cfg, p.traffic)
    return {"steps": n, "seconds": t1 - t0, "positions": pos,
            "train_tokens_per_s": pos / (t1 - t0),
            "online_bits": p.online_bits() - bits0}


def run(c: dict, seed: int, seconds: float, trace: bool, device,
        t_start: float) -> dict:
    cfg, traffic = c["config"], c["traffic"]
    p = Program(cfg, traffic, seed, device)
    prog = p.check_readings()
    w = None
    summary = counts = None
    if trace:
        t_set = time.perf_counter()
        summary, counts = traced(p, traffic["trace_steps"])
        attempted = traffic["trace_steps"]
    else:
        t_set = time.perf_counter()
        w = window(p, seconds)
        attempted = w["steps"]
    setup_s = t_set - t_start - prog["read_s"]
    peak = torch.cuda.max_memory_allocated() \
        if torch.device(device).type == "cuda" else 0
    p.free()
    del p
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    refr = reference_readings(cfg, traffic, seed, device)
    return {"numbers": numbers(cfg, prog, refr), "attempted": attempted,
            "failed": 0, "peak": peak, "trace": summary, "counts": counts,
            "values": None if w is None else {
                "train_tokens_per_s": w["train_tokens_per_s"],
                "setup_s": setup_s},
            "window": w, "setup_s": setup_s}

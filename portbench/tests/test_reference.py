"""The reference against the port at SMOKE widths on the CPU.

The port's own float64 engine, given fixed point's mean behaviour (the
engine below), computes the same model as the reference: their losses,
gradients and logits agree to float64 rounding.  The secure program lies
within the truncations' noise of the reference.  The reference imports
nothing of the port; only this test does."""
import pytest
import torch

from portbench import lm
from portbench.drivers import serve_closed as S
from portbench.drivers import train_steps as T
from portbench.reference import dense_vlm as ref
from portbench.tests.small import small_cell

UNIT = 2.0 ** -13
# the secure run at SMOKE widths against the reference (8 seeds on the
# CPU: loss within 1.2e-4, gradients within 0.03-0.21 relative L2 of all
# leaves; served tokens within 0.0-0.02 of the best logit)
REL_L2 = 0.3
LOGIT_GAP = 0.1
LOGIT_ERR = 0.1


def fixed_point_engine():
    """The port's PlainEngine with fixed point's mean behaviour: encoded
    inputs and constants rounded to units, each truncation -1 unit, the
    mean's 1/n encoded, rsqrt and reciprocal rounded to units."""
    from repro_torch.nn.engine import Engine, PlainEngine

    def q(x):
        return torch.round(x / UNIT) * UNIT

    class FixedPointPlain(PlainEngine):
        def from_plain(self, x):
            return q(self._t(x))

        def _encode_public(self, c):
            return q(self._t(c))

        def matmul(self, x, w):
            return torch.matmul(x, w) - UNIT

        def mul(self, x, y):
            return x * y - UNIT

        def _truncate(self, x):
            return x - UNIT

        def mean(self, x, axis, keepdims=False):
            return Engine.mean(self, x, axis, keepdims)

        def softmax(self, x, axis=-1, mask=None):
            r, bit = self.relu(x)
            if mask is not None:
                r = r * self._t(mask)
            inv = self.reciprocal(torch.sum(r, dim=axis, keepdim=True)
                                  + self._encode_public(1e-2))
            p = self.mul(r, inv)
            return p, (p, inv, bit)

        def softmax_bwd(self, cache, dp, mask=None):
            p, inv, bit = cache
            inner = torch.sum(self.mul(dp, p), dim=-1, keepdim=True)
            dr = self.mul(dp - inner, inv)
            if mask is not None:
                dr = dr * self._t(mask)
            return dr * bit.to(self.dtype)

        def silu_bwd(self, cache, dy):
            x, s, seg = cache
            return self.mul(dy, s) + self.mul(dy, x) * seg.to(self.dtype)

        def rsqrt(self, x):
            y = q(torch.where(x <= 0, 0.0,
                              torch.rsqrt(torch.clamp_min(x, UNIT))))
            return y, (x, y)

        def reciprocal(self, x):
            return q(torch.where(x.abs() < UNIT, 0.0, 1.0 / torch.where(
                x == 0, 1.0, x)))

    return FixedPointPlain(device="cpu")


def _port_grads(eng, cfg, traffic, seed):
    from repro_torch.nn import model as M
    pe = M.params_to_engine(eng, lm.program_tree(
        cfg, lm.make_weights(cfg, seed, "cpu")))
    ids, labels, front = T.batch(cfg, traffic, seed, 0, "cpu")
    loss, g = M.loss_and_grads(eng, lm.model_config(cfg), pe, ids, labels,
                               frontend_embs=eng.from_plain(front))
    if hasattr(eng, "ctx"):
        return float(loss), dict(lm.program_parts(cfg, eng, g))
    leaves = lm.layout(cfg).program_leaves(g)
    return float(loss), lm.reference_parts(
        cfg, lm.reference_tree(cfg, leaves))


def _ref_grads(cfg, traffic, seed):
    fx = ref.FixedPoint(13)
    p0 = ref.encode(fx, lm.reference_tree(cfg, lm.make_weights(cfg, seed,
                                                               "cpu")))
    ids, labels, front = T.batch(cfg, traffic, seed, 0, "cpu")
    loss, g = ref.grads(fx, p0, lm.ref_cfg(cfg), ids, labels, front)
    return loss, lm.reference_parts(cfg, g)


@pytest.mark.parametrize("seed", [3, 4])
def test_reference_is_the_ports_model_in_float64(seed):
    c = small_cell("phi3v-train")
    loss_p, gp = _port_grads(fixed_point_engine(), c["config"],
                             c["traffic"], seed)
    loss_r, gr = _ref_grads(c["config"], c["traffic"], seed)
    assert loss_p == pytest.approx(loss_r, abs=1e-6)   # a float32 loss
    for k, r in gr.items():
        torch.testing.assert_close(gp[k], r, rtol=0, atol=1e-12)


@pytest.mark.parametrize("seed", [3, 4])
def test_secure_gradient_lies_near_the_reference(seed):
    c = small_cell("phi3v-train")
    eng = lm.engine(c["config"], seed, "cpu")
    loss_p, gp = _port_grads(eng, c["config"], c["traffic"], seed)
    loss_r, gr = _ref_grads(c["config"], c["traffic"], seed)
    assert abs(loss_p - loss_r) < 2e-3
    num = sum(float(torch.linalg.vector_norm(gp[k] - r)) ** 2
              for k, r in gr.items())
    den = sum(float(torch.linalg.vector_norm(r)) ** 2 for r in gr.values())
    assert (num / den) ** 0.5 < REL_L2


def test_served_logits_are_the_ports_in_float64():
    from repro_torch.nn import model as M
    c = small_cell("phi3v-serve")
    cfg, traffic = c["config"], c["traffic"]
    eng = fixed_point_engine()
    mcfg = lm.model_config(cfg)
    pe = M.params_to_engine(eng, lm.program_tree(
        cfg, lm.make_weights(cfg, 9, "cpu")))
    ids, front = S.request(cfg, traffic, 9, 2, "cpu")
    logits, caches = M.serve_prefill(eng, mcfg, pe, ids,
                                     frontend_embs=eng.from_plain(front))
    got, toks = [logits.reshape(-1)], [5, 17]
    pos = cfg["frontend_tokens"] + ids.shape[1]
    for j, t in enumerate(toks):
        logits, caches = M.serve_decode(eng, mcfg, pe, torch.tensor([[t]]),
                                        caches, pos + j)
        got.append(logits.reshape(-1))
    fx = ref.FixedPoint(13)
    params = ref.encode(fx, lm.reference_tree(cfg, lm.make_weights(cfg, 9,
                                                                   "cpu")))
    full = torch.cat([ids, torch.tensor([toks])], dim=1)
    want = ref.served_logits(fx, params, lm.ref_cfg(cfg), full, front)
    # within 8 units of 2^-13: a product summed in another order (a longer
    # pass, a decode step against a prefill) can round a reciprocal or an
    # rsqrt to the next unit; the port's own decode and prefill of one
    # position differ so by 2.6e-5 here
    torch.testing.assert_close(torch.stack(got), want[0, ids.shape[1] - 1:],
                               rtol=0, atol=8 * UNIT)


def test_secure_served_logits_lie_near_the_reference():
    c = small_cell("phi3v-serve")
    p = S.Program(c["config"], c["traffic"], 9, "cpu")
    r = p.serve(1)
    gaps, err = S.reference_gaps(c["config"], c["traffic"], 9, "cpu", [r])
    assert err < LOGIT_ERR
    assert max(gaps[0]) < LOGIT_GAP

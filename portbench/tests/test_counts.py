"""The yardstick's counts against hand counts at two shapes."""
import pytest

from portbench import flops, lm


def test_ring_matmul_bound_2d_hand_count():
    # (704 x 3072) @ (3072 x 8192): ops bound, 36 limb pairs x 2 M N K
    ops = 36 * 2 * 704 * 3072 * 8192
    assert flops.ring_matmul_bound_s((704, 3072), (3072, 8192)) == \
        pytest.approx(ops / 1979e12)
    # a thin product is bound by its bytes: 8 B a word, A, B and C once
    nbytes = 8 * (1 * 3072 + 3072 * 32064 + 1 * 32064)
    assert flops.ring_matmul_bound_s((1, 1, 3072), (3072, 32064)) == \
        pytest.approx(nbytes / 3.35e12)


def test_ring_matmul_bound_batched_hand_count():
    # attention's scores, (1, 32, 704, 96) @ (1, 32, 96, 704)
    ops = 36 * 2 * 32 * 704 * 704 * 96
    nbytes = 8 * (32 * 704 * 96 * 2 + 32 * 704 * 704)
    want = max(ops / 1979e12, nbytes / 3.35e12)
    assert flops.ring_matmul_bound_s((1, 32, 704, 96),
                                     (1, 32, 96, 704)) == pytest.approx(want)
    assert flops.matmul_dims((4, 1, 5, 7), (1, 3, 7, 2)) == (12, 5, 7, 2)
    assert flops.limb_pairs(8) == 36 and flops.limb_pairs(4) == 10


SIZES = [dict(d=3072, h=32, hk=32, dh=96, f=8192, v=32064, layers=2),
         dict(d=32, h=4, hk=2, dh=8, f=48, v=128, layers=3)]


@pytest.mark.parametrize("s", SIZES)
def test_train_and_prefill_ops_hand_count(s):
    pos, labels = 20, 7
    per_layer = 2 * pos * (s["d"] * s["h"] * s["dh"] * 2
                           + s["d"] * s["hk"] * s["dh"] * 2
                           + 3 * s["d"] * s["f"])
    causal = pos * (pos + 1) // 2
    attn = 2 * 2 * causal * s["h"] * s["dh"]
    fwd = s["layers"] * (per_layer + attn) + 2 * s["d"] * s["v"] * labels
    assert flops.train_step_ops(s, pos, labels) == 3 * fwd
    pre = s["layers"] * (per_layer + attn) + 2 * s["d"] * s["v"]
    assert flops.prefill_ops(s, pos) == pre
    dec = s["layers"] * (2 * (s["d"] * s["h"] * s["dh"] * 2
                              + s["d"] * s["hk"] * s["dh"] * 2
                              + 3 * s["d"] * s["f"])
                         + 2 * 2 * (pos + 1) * s["h"] * s["dh"]) \
        + 2 * s["d"] * s["v"]
    assert flops.decode_ops(s, pos) == dec


@pytest.mark.parametrize("workload,layers", [("phi3v-train", 1),
                                             ("phi3v-serve", 11)])
def test_parameter_count_of_the_configuration(workload, layers):
    from portbench import harness
    cfg = harness.cell(workload)["config"]
    d, f, v = 3072, 8192, 32064
    want = 2 * v * d + d + layers * (2 * d + 4 * d * d + 3 * d * f)
    assert lm.parameter_count(cfg) == want == cfg["parameters"]

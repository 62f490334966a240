"""The window's accounting: a step or a request that starts inside the
window counts whole, with its time, and none starts after it; serving
runs whole cycles of its prompt lengths."""
import time

from portbench import harness


class FakeTrain:
    cfg = {"hidden_size": 8, "num_attention_heads": 2,
           "num_key_value_heads": 2, "intermediate_size": 8,
           "vocab_size": 16, "num_hidden_layers": 1, "frontend_tokens": 6}
    traffic = {"batch": 1, "ids": 4}

    def __init__(self, dur):
        self.dur, self.starts = dur, []

    def step(self):
        self.starts.append(time.perf_counter())
        time.sleep(self.dur)

    def online_bits(self):
        return 100 * len(self.starts)


def test_train_window_counts_a_straddling_step_whole():
    d = harness.driver("train_steps")
    p = FakeTrain(0.12)
    t0 = time.perf_counter()
    w = d.window(p, 0.3)
    # steps start at about 0, 0.12 and 0.24 s; the third ends at 0.36 s,
    # past the window, and counts whole; no fourth starts
    assert w["steps"] == 3 == len(p.starts)
    assert all(s - t0 < 0.3 for s in p.starts)
    assert w["seconds"] >= 0.36
    assert w["positions"] == 3 * 10
    assert w["train_tokens_per_s"] == w["positions"] / w["seconds"]
    assert w["online_bits"] == 300


class FakeServe:
    def __init__(self, dur, prompt_ids=(4,)):
        self.dur, self.n = dur, 0
        self.traffic = {"prompt_ids": list(prompt_ids)}

    def serve(self, i):
        self.n += 1
        time.sleep(self.dur)
        return {"i": i, "prompt": 4, "tokens": [1, 2, 3],
                "ttft": self.dur / 2, "decode": [self.dur / 4] * 2}

    def online_bits(self):
        return 0


def test_serve_window_counts_a_straddling_request_whole():
    d = harness.driver("serve_closed")
    p = FakeServe(0.1)
    w = d.window(p, 0.25)
    assert len(w["requests"]) == 3 == p.n
    assert w["seconds"] >= 0.3
    assert abs(w["ttft_s"] - 0.05) < 1e-12
    assert abs(w["tpot_ms"] - 25.0) < 1e-9


def test_serve_window_runs_whole_cycles_of_the_prompt_lengths():
    d = harness.driver("serve_closed")
    p = FakeServe(0.1, (4, 8))
    w = d.window(p, 0.25)
    # the third request starts inside the window; the fourth finishes its
    # cycle of two prompt lengths; no fifth starts
    assert len(w["requests"]) == 4 == p.n
    assert w["seconds"] >= 0.4

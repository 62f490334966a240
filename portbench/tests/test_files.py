"""A cell, a traffic mix and a per-layer metric added as files and
entries, in a copy of the benchmark: the harness finds them by name with
no file of its own edited."""
import json
import shutil

from portbench import harness


def test_new_cell_and_metric_are_found_by_name(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(harness.BENCH, root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(harness.ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    before = {p.relative_to(root): p.read_bytes()
              for p in (root / "portbench").rglob("*") if p.is_file()}
    # the new files
    traffic = {"kind": "serve_closed", "prompt_ids": [512], "new_tokens": 4,
               "check_requests": 8, "trace_requests": 1}
    (root / "portbench/traffic/closed1.ids512.new4.json").write_text(
        json.dumps(traffic))
    (root / "portbench/limits/phi3v-longprompt.json").write_text(
        json.dumps({"logit_gap": 0.5}))
    (root / "portbench/metrics/idle_share.longprompt.py").write_text(
        "def read(run):\n    return run.idle_share('prefill')\n")
    # the new entries
    man = json.loads((root / "BENCHMARK.json").read_text())
    man["workloads"].append({"name": "phi3v-longprompt",
                             "config": "phi3v-4.2b.11of32",
                             "traffic": "closed1.ids512.new4", "chips": 1,
                             "why": "long prompts"})
    man["per_layer"].append({"name": "idle_share.longprompt", "unit": "%",
                             "better": "lower", "source": "device_trace",
                             "layer": "device", "moves": "ttft_s",
                             "workloads": ["phi3v-longprompt"]})
    man["end_to_end"][1]["workloads"].append("phi3v-longprompt")
    (root / "BENCHMARK.json").write_text(json.dumps(man))

    c = harness.cell("phi3v-longprompt", root=root)
    assert c["traffic"]["prompt_ids"] == [512]
    assert c["limits"] == {"logit_gap": 0.5}
    assert c["config"]["hidden_size"] == 3072
    assert [m["name"] for m in c["per_layer"]] == ["idle_share.longprompt"]
    assert [m["name"] for m in c["end_to_end"]] == ["ttft_s", "setup_s"]
    drv = harness.driver(c["traffic"]["kind"], c["bench"])
    assert callable(drv.run)
    rd = harness.reader("idle_share.longprompt", c["bench"])
    run = harness.Readings({"phases": {"prefill": {
        "span_s": 2.0, "busy_s": 1.5, "device_ops": 10,
        "ring_matmul_device_s": 0.5}}}, {})
    assert rd.read(run) == 25.0
    # and nothing the benchmark had was edited
    after = {p: (root / p).read_bytes() for p in before}
    assert after == before


def test_a_reader_with_nothing_to_read_leaves_its_metric_out():
    c = harness.cell("phi3v-serve")
    run = harness.Readings({"phases": {}}, {})
    assert harness.per_layer(c, run) == {}

"""``prof`` of the port (sheeprl_tpu_torch/prof/) over ``torch.profiler``
(Kineto) Chrome traces: a synthetic CUDA capture gives an exact table
(kernels on two overlapping streams and a copy on a third, launches under
nested annotations, a host scope that closes before its kernel runs, a
backward launched from a thread with no scope open, a memset launched
outside every scope, runtime noise); a real ``torch.profiler`` capture of a
CPU run of the port renders through the ``prof`` CLI with the run's
roofline events folded in; the argv grammar is the JAX package's, and the
report's keys are those of the JAX ``summarize_capture`` on its own golden
fixture."""
from torch_threads import one_thread  # noqa: F401  (autouse: one intra-op thread for the module)
import contextlib
import gzip
import io
import json
from pathlib import Path

import pytest

import sheeprl_tpu.prof.cli as jax_prof_cli
from sheeprl_tpu.prof import summarize_capture as jax_summarize_capture
from sheeprl_tpu_torch import cli
from sheeprl_tpu_torch.prof import CaptureError, find_trace_files, parse_trace_file, summarize_capture
from sheeprl_tpu_torch.prof.cli import parse_prof_argv, prof_report, render_text
from test_prof import _write_golden_capture
from test_torch_fleet import COMMON, SAC

HOST, DEV = 4242, 0
LEARNER, AUTOGRAD, PLAYER = 1, 2, 3


def _x(cat, name, pid, tid, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "pid": pid, "tid": tid, "ts": ts, "dur": dur, "args": args}


# Every expected number below is derived by hand from these intervals (µs).
GOLDEN_KINETO = [
    {"ph": "M", "name": "process_name", "pid": HOST, "tid": 0, "args": {"name": "python3"}},
    {"ph": "M", "name": "process_name", "pid": DEV, "tid": 0, "args": {"name": "GPU 0"}},
    {"ph": "M", "name": "thread_name", "pid": HOST, "tid": LEARNER, "args": {"name": "thread 1 (python3)"}},
    _x("Trace", "PyTorch Profiler (0)", HOST, LEARNER, 400, 6100),
    # the learner's thread: the step range nests the train-time span, which
    # nests `wm`, a scope that closes (1500) before its kernel runs (2000)
    _x("user_annotation", "train#7", HOST, LEARNER, 1000, 4000),
    _x("user_annotation", "Time/train_time", HOST, LEARNER, 1100, 2900),
    _x("user_annotation", "wm", HOST, LEARNER, 1200, 300),
    _x("cpu_op", "aten::mm", HOST, LEARNER, 1250, 100),
    _x("python_function", "train.py(12): burst", HOST, LEARNER, 1100, 2900),
    _x("cuda_runtime", "cudaLaunchKernel", HOST, LEARNER, 1300, 10, correlation=1),
    _x("cuda_runtime", "cudaLaunchKernelExC", HOST, LEARNER, 1600, 10, correlation=2),
    _x("cuda_runtime", "cudaMemcpyAsync", HOST, LEARNER, 1700, 10, correlation=3),
    _x("cuda_runtime", "cudaMemsetAsync", HOST, LEARNER, 500, 10, correlation=6),
    # autograd's backward thread: no scope of its own
    _x("cuda_driver", "cuLaunchKernel", HOST, AUTOGRAD, 3000, 10, correlation=4),
    # the player's thread: its own span
    _x("user_annotation", "Time/env_interaction_time", HOST, PLAYER, 1000, 5000),
    _x("cuda_runtime", "cudaLaunchKernel", HOST, PLAYER, 2000, 10, correlation=5),
    # the card: stream 7 (the learner's), 20 (the staged feed's copy), 21 (the player's)
    _x("kernel", "gemm_a", DEV, 7, 2000, 400, device=0, stream=7, correlation=1),
    _x("kernel", "ln_gru_fwd_kernel", DEV, 7, 2400, 600, device=0, stream=7, correlation=2),
    _x("gpu_memcpy", "Memcpy HtoD (Pinned -> Device)", DEV, 20, 2500, 200, device=0, stream=20, correlation=3),
    _x("kernel", "ln_gru_bwd_kernel", DEV, 7, 3200, 400, device=0, stream=7, correlation=4),
    _x("kernel", "player_kernel", DEV, 21, 2100, 200, device=0, stream=21, correlation=5),
    _x("gpu_memset", "Memset (Device)", DEV, 7, 600, 100, device=0, stream=7, correlation=6),
    # noise: a device-side annotation lane and flow arrows are never device time
    _x("gpu_user_annotation", "Time/train_time", DEV, 7, 2000, 1000),
    {"ph": "s", "cat": "ac2g", "name": "ac2g", "id": 1, "pid": HOST, "tid": LEARNER, "ts": 1300},
    {"ph": "f", "cat": "ac2g", "name": "ac2g", "id": 1, "pid": DEV, "tid": 7, "ts": 2000, "bp": "e"},
]


def _write_kineto(path: Path, events=GOLDEN_KINETO) -> Path:
    path.parent.mkdir(parents=True, exist_ok=True)
    doc = {"schemaVersion": 1, "traceEvents": events}
    if str(path).endswith(".gz"):
        with gzip.open(path, "wt") as fh:
            json.dump(doc, fh)
    else:
        path.write_text(json.dumps(doc))
    return path


def test_parse_kineto_trace_splits_device_ops_scopes_launches_and_noise(tmp_path):
    parsed = parse_trace_file(_write_kineto(tmp_path / "trace_step7.json"))
    assert parsed["platform"] == "gpu"
    assert [op["name"] for op in parsed["ops"]] == ["gemm_a", "ln_gru_fwd_kernel", "Memcpy HtoD (Pinned -> Device)",
                                                    "ln_gru_bwd_kernel", "player_kernel", "Memset (Device)"]
    assert [op["hlo_module"] for op in parsed["ops"]] == ["kernel", "kernel", "gpu_memcpy", "kernel", "kernel",
                                                          "gpu_memset"]
    assert [(s["name"], s.get("step_num")) for s in parsed["scopes"]] == [
        ("train", 7), ("Time/train_time", None), ("wm", None), ("Time/env_interaction_time", None)]
    assert sorted(parsed["launches"]) == [1, 2, 3, 4, 5, 6]
    assert (parsed["t_min_us"], parsed["t_max_us"]) == (400.0, 6500.0)


@pytest.mark.parametrize("name", ["trace_step7.json", "trace_step7.json.gz"])
def test_summarize_kineto_capture_pins_golden_table_exactly(name, tmp_path):
    """gemm_a's launch ran under `wm`, which closed before the kernel ran
    (a midpoint rule would say Time/train_time); the backward's launch came
    from a thread with no scope and takes the innermost scope of the thread
    whose step range encloses it; the memset's launch is outside every
    scope. Busy is the union over the device's streams: [600, 700] +
    [2000, 3000] + [3200, 3600] = 1500 µs of a 6100 µs window."""
    _write_kineto(tmp_path / name)
    rep = summarize_capture(tmp_path)
    assert rep["files"] == 1 and rep["op_kinds"] == 6 and rep["steps"] == [7]
    assert rep["device_busy_us"] == 1500.0
    assert rep["device_idle_frac"] == round(1 - 1500 / 6100, 4)
    assert rep["ops"] == [
        {"op": "ln_gru_fwd_kernel", "hlo_module": "kernel", "count": 1, "total_us": 600.0, "frac": 0.3158,
         "scope": "Time/train_time"},
        {"op": "gemm_a", "hlo_module": "kernel", "count": 1, "total_us": 400.0, "frac": 0.2105, "scope": "wm"},
        {"op": "ln_gru_bwd_kernel", "hlo_module": "kernel", "count": 1, "total_us": 400.0, "frac": 0.2105,
         "scope": "Time/train_time"},
        {"op": "Memcpy HtoD (Pinned -> Device)", "hlo_module": "gpu_memcpy", "count": 1, "total_us": 200.0,
         "frac": 0.1053, "scope": "Time/train_time"},
        {"op": "player_kernel", "hlo_module": "kernel", "count": 1, "total_us": 200.0, "frac": 0.1053,
         "scope": "Time/env_interaction_time"},
        {"op": "Memset (Device)", "hlo_module": "gpu_memset", "count": 1, "total_us": 100.0, "frac": 0.0526,
         "scope": ""},
    ]
    assert rep["scopes"] == {
        "Time/train_time": {"device_us": 1200.0, "frac": 0.6316},
        "wm": {"device_us": 400.0, "frac": 0.2105},
        "Time/env_interaction_time": {"device_us": 200.0, "frac": 0.1053},
        "(unscoped)": {"device_us": 100.0, "frac": 0.0526},
    }
    (window,) = rep["windows"]
    assert window == {"file": str(tmp_path / name), "host": "python3", "platform": "gpu", "device_lanes": 1,
                      "window_us": 6100.0, "device_busy_us": 1500.0, "device_idle_frac": 0.7541}
    assert [r["op"] for r in summarize_capture(tmp_path, top_k=2)["ops"]] == ["ln_gru_fwd_kernel", "gemm_a"]


def test_two_devices_are_two_lanes_and_two_launching_threads_leave_a_launch_unscoped(tmp_path):
    extra = [_x("kernel", "k_dev1", 1, 9, 2000, 500, device=1, stream=9, correlation=7),
             _x("cuda_runtime", "cudaLaunchKernel", HOST, 5, 2000, 10, correlation=7),
             _x("user_annotation", "other", HOST, 6, 1900, 200)]
    # a launch on a scope-less thread while two other threads (neither with
    # a step range) hold scopes: no thread to take the scope from
    events = [e for e in GOLDEN_KINETO if e.get("name") != "train#7"] + extra
    rep = summarize_capture(_write_kineto(tmp_path / "trace.json", events))
    assert rep["windows"][0]["device_lanes"] == 2
    assert rep["device_busy_us"] == 2000.0
    assert rep["device_idle_frac"] == round(1 - 2000 / (6100 * 2), 4)
    rows = {r["op"]: r for r in rep["ops"]}
    assert rows["k_dev1"]["scope"] == "" and rows["ln_gru_bwd_kernel"]["scope"] == ""
    assert rep["steps"] == []


def test_cpu_capture_counts_cpu_ops_by_self_time(tmp_path):
    events = [
        {"ph": "M", "name": "process_name", "pid": HOST, "tid": 0, "args": {"name": "python3"}},
        _x("user_annotation", "train#3", HOST, LEARNER, 0, 1000),
        _x("cpu_op", "aten::linear", HOST, LEARNER, 100, 500),
        _x("cpu_op", "aten::addmm", HOST, LEARNER, 150, 300),
        _x("cpu_op", "aten::relu", HOST, LEARNER, 700, 100),
        _x("cuda_runtime", "cudaLaunchKernel", HOST, LEARNER, 200, 5, correlation=1),
    ]
    rep = summarize_capture(_write_kineto(tmp_path / "trace.json", events))
    assert rep["windows"][0]["platform"] == "cpu" and rep["windows"][0]["device_lanes"] == 1
    assert {r["op"]: r["total_us"] for r in rep["ops"]} == {"aten::addmm": 300.0, "aten::linear": 200.0,
                                                           "aten::relu": 100.0}
    assert rep["device_busy_us"] == 600.0 and rep["device_idle_frac"] == 0.4
    assert {r["scope"] for r in rep["ops"]} == {"train"} and rep["steps"] == [3]


def test_find_trace_files_and_errors(tmp_path):
    _write_kineto(tmp_path / "trace" / "trace_step8.json")
    _write_kineto(tmp_path / "watchdog_trace" / "incident_000_1" / "trace.json")
    _write_kineto(tmp_path / "other" / "x.pt.trace.json.gz")
    (tmp_path / "live.json").write_text("{}")
    (tmp_path / "telemetry.jsonl").write_text("")
    assert [p.relative_to(tmp_path).as_posix() for p in find_trace_files(tmp_path)] == [
        "other/x.pt.trace.json.gz", "trace/trace_step8.json", "watchdog_trace/incident_000_1/trace.json"]
    with pytest.raises(CaptureError):
        summarize_capture(tmp_path / "nowhere")
    bad = tmp_path / "bad" / "trace.json"
    bad.parent.mkdir()
    bad.write_text("not json")
    with pytest.raises(CaptureError):
        summarize_capture(bad)
    assert find_trace_files(tmp_path / "nowhere") == []


def test_argv_contract_and_report_keys_are_the_jax_packages(tmp_path):
    for argv in (["run_dir=a"], ["capture=c", "top_k=3"], ["a", "--json"], ["run_dir=a", "json=true", "top_k=2"]):
        assert parse_prof_argv(argv) == jax_prof_cli.parse_prof_argv(argv)
    for argv in ([], ["nonsense=1"], ["top_k=3"]):
        with pytest.raises(ValueError):
            parse_prof_argv(argv)
    ref = jax_summarize_capture(_write_golden_capture(tmp_path / "jax").parent.parent.parent.parent)
    mine = summarize_capture(_write_kineto(tmp_path / "port" / "trace_step7.json"))
    assert list(mine) == list(ref)
    assert [list(r) for r in mine["ops"]] == [list(ref["ops"][0])] * len(mine["ops"])
    assert list(mine["scopes"]["wm"]) == list(ref["scopes"]["train"])
    # a window adds the platform it was captured on
    assert [k for k in mine["windows"][0] if k != "platform"] == list(ref["windows"][0])


def test_prof_report_folds_rooflines_and_discovers_announced_captures(tmp_path):
    cap = tmp_path / "elsewhere" / "trace"
    _write_kineto(cap / "trace_step8.json")
    run = tmp_path / "run"
    run.mkdir()
    events = [
        {"event": "startup", "platform": "gpu", "device_kind": "NVIDIA H100", "devices": 1, "rank": 0},
        {"event": "trace", "step": 8, "action": "started", "trace_dir": str(cap)},
        {"event": "roofline", "fn": "train_step", "flops": 1e9, "bytes_accessed": 1e9, "intensity": 1.0,
         "bound": "memory", "ridge_intensity": 34.5},
        {"event": "roofline", "fn": "train_step", "flops": 1e9, "bytes_accessed": 1e9, "intensity": 1.0,
         "bound": "memory", "ridge_intensity": 34.5, "calls_per_s": 12.0, "attained_frac": 0.25},
        {"event": "shutdown", "step": 64},
    ]
    (run / "telemetry.jsonl").write_text("".join(json.dumps(e) + "\n" for e in events))
    report = prof_report(run_dir=run)
    assert [c["capture_dir"] for c in report["captures"]] == [str(cap.resolve())]
    assert report["rooflines"] == jax_prof_cli.prof_report(run_dir=run)["rooflines"]
    assert report["rooflines"][0]["attained_frac"] == 0.25
    text = render_text(report)
    assert "roofline verdicts" in text and "memory-bound" in text and "attained 25.0% of roof" in text
    assert "ln_gru_fwd_kernel" in text and "idle 75.4%" in text


def test_prof_over_a_real_cpu_capture_of_a_port_run(tmp_path, monkeypatch):
    """A SAC run on the CPU with the windowed capture on: ``prof
    run_dir=...`` finds its trace_step<N>.json, reads its cpu_op events
    under the step ranges and the train-time span, and folds in the
    roofline the run registered."""
    monkeypatch.chdir(tmp_path)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.run(SAC + COMMON + ["algo.total_steps=48", "metric.telemetry.trace_every=24",
                                "metric.telemetry.trace_window=8", "run_name=prof"])
    log_dir = Path(next(l.split("=", 1)[1] for l in buf.getvalue().splitlines() if "] log_dir=" in l))
    (capture,) = find_trace_files(log_dir)
    start = int(capture.name[len("trace_step"):-len(".json")])
    assert 24 <= start < 32
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.COMMANDS["prof"]([f"run_dir={log_dir}", "json=true"])
    report = json.loads(buf.getvalue())
    (cap,) = report["captures"]
    assert cap["windows"][0]["platform"] == "cpu" and cap["device_busy_us"] > 0
    assert cap["ops"] and all(r["hlo_module"] == "cpu_op" for r in cap["ops"])
    assert cap["steps"] and set(cap["steps"]) <= set(range(start, start + 9))
    assert "Time/train_time" in cap["scopes"]
    assert [r["fn"] for r in report["rooflines"]]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.COMMANDS["prof"]([f"run_dir={log_dir}"])
    assert "op(s) by device time" in buf.getvalue() and "device share by scope" in buf.getvalue()

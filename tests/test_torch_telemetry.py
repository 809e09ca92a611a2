"""The port's telemetry stream (sheeprl_tpu_torch/telemetry/) against the
JAX package's: a CLI run's ``telemetry.jsonl`` passes both packages'
``validate_jsonl``; the schema's event types carry the reference's fields
letter for letter; the JSONL sink's size-bounded rotation, the TensorBoard
logger's fallback stream, the span tracker, the throughput and roofline
arithmetic (held against the reference's functions on the same inputs), the
model-cost counter, the memory sampler and the resilience events."""
import json
import sys

import numpy as np
import pytest
import torch

from sheeprl_tpu.telemetry import schema as jax_schema
from sheeprl_tpu.telemetry import throughput as jax_throughput
from sheeprl_tpu_torch.telemetry import device as device_counters
from sheeprl_tpu_torch.telemetry import schema, throughput
from sheeprl_tpu_torch.telemetry.facade import Telemetry
from sheeprl_tpu_torch.telemetry.memory import MemorySampler, memory_snapshot
from sheeprl_tpu_torch.telemetry.sinks import JsonlSink
from sheeprl_tpu_torch.telemetry.spans import SpanTracker
from sheeprl_tpu_torch.utils.logger import TensorBoardLogger, get_logger


def _events(path):
    with open(path) as fh:
        return [json.loads(line) for line in fh if line.strip()]


def _both_validate(path):
    assert schema.validate_jsonl(path) == []
    assert jax_schema.validate_jsonl(path) == []


def test_schema_fields_are_the_references():
    """Every event type the port emits has the reference's fields, each with
    the same required flag and type."""
    assert schema.SCHEMA_VERSION == jax_schema.SCHEMA_VERSION
    for event, fields in schema.EVENT_SCHEMAS.items():
        assert jax_schema.EVENT_SCHEMAS[event] == fields, event
    for event in ("startup", "log", "shutdown", "metrics", "overlap", "ckpt_async", "preempt", "resume", "mem",
                  "roofline", "retry", "watchdog"):
        assert event in schema.EVENT_SCHEMAS, event
    assert schema.validate_event({"event": "log"}) == jax_schema.validate_event({"event": "log"})
    assert schema.validate_event({"event": "mem", "role": "learner", "rss_bytes": True}) == [
        "mem: field 'rss_bytes' is bool, expected number"]


def _cli_run(tmp_path, monkeypatch, capsys, *extra):
    from dreamer_tiny import TINY_DV3
    from sheeprl_tpu_torch import cli

    monkeypatch.chdir(tmp_path)
    cli.run(TINY_DV3 + ["fabric.accelerator=cpu", "env.num_envs=2", "algo.learning_starts=8", "buffer.size=64",
                        "metric.log_every=8", "algo.run_test=False", "algo.total_steps=24", "checkpoint.every=16",
                        *extra])
    out = capsys.readouterr()
    log_dir = next(l.split("=", 1)[1] for l in out.out.splitlines() if l.startswith("[dreamer_v3] log_dir="))
    return log_dir, out


def test_cli_run_stream_passes_both_validators(tmp_path, monkeypatch, capsys):
    """A CLI run on the CPU writes ``<log_dir>/telemetry.jsonl`` that both
    packages' ``validate_jsonl`` accept: the startup record (platform cpu),
    a log record per interval with MFU, memory, spans and the device
    counters, the train step's roofline, the engine's overlap records (the
    last one final), the checkpoint writer's records, memory samples and the
    shutdown summary; a resumed run adds its resume event."""
    log_dir, out = _cli_run(tmp_path, monkeypatch, capsys, "run_name=first")
    path = f"{log_dir}/telemetry.jsonl"
    _both_validate(path)
    events = _events(path)
    kinds = {e["event"] for e in events}
    assert {"startup", "log", "roofline", "overlap", "ckpt_async", "mem", "shutdown"} <= kinds, kinds
    start = events[0]
    assert start["event"] == "startup" and start["platform"] == "cpu" and start["algo"] == "dreamer_v3"
    assert "[telemetry rank=0] platform=cpu" in out.err
    logs = [e for e in events if e["event"] == "log"]
    trained = [e for e in logs if e["grad_steps"] > 0]
    assert trained and all(e["throughput"]["mfu"] > 0 for e in trained[1:])
    assert all(e["memory"]["rss_bytes"] > 0 and "hbm_peak_bytes" not in e["memory"] for e in logs)
    assert "Time/train_time" in trained[-1]["spans"] and "Loss/world_model_loss" in trained[-1]["metrics"]
    assert trained[-1]["device"]["ln_gru_launches"] == {k: 0 for k in trained[-1]["device"]["ln_gru_launches"]}
    roof = [e for e in events if e["event"] == "roofline"]
    assert roof[0]["fn"] == "train_step" and roof[0]["flops"] > 0 and roof[0]["bytes_accessed"] > 0
    assert [e for e in events if e["event"] == "overlap"][-1]["final"]
    assert [e["action"] for e in events if e["event"] == "ckpt_async"][:2] == ["enqueued", "written"]
    assert events[-1]["event"] == "shutdown" and events[-1]["total_grad_steps"] == logs[-1]["grad_steps"]
    ckpt = sorted((tmp_path / "logs").rglob("ckpt_24.ckpt"))[0]
    log_dir2, _ = _cli_run(tmp_path, monkeypatch, capsys, "run_name=second", "algo.total_steps=32",
                           f"checkpoint.resume_from={ckpt}")
    _both_validate(f"{log_dir2}/telemetry.jsonl")
    resumed = [e for e in _events(f"{log_dir2}/telemetry.jsonl") if e["event"] == "resume"]
    assert resumed == [{"event": "resume", "step": 0, "checkpoint": str(ckpt)}]


def test_cli_run_with_the_stream_off_trains_and_leaves_no_stream(tmp_path, monkeypatch, capsys):
    """``metric.telemetry.enabled=False`` (the off arm of the telemetry's
    cost A/B): the loop takes its steps and checkpoints, costs no step, and
    writes no stream."""
    log_dir, out = _cli_run(tmp_path, monkeypatch, capsys, "run_name=stream_off", "metric.telemetry.enabled=False")
    assert not (tmp_path / log_dir / "telemetry.jsonl").exists()
    state = torch.load(sorted((tmp_path / "logs").rglob("ckpt_24.ckpt"))[0], weights_only=False)
    assert state["policy_step"] == 24 and state["opt_states"]["step"] > 0


# each switch of the facade, and what it turns off
SWITCHES = {
    "none": [],
    "jsonl": ["metric.telemetry.jsonl=False"],
    "heartbeat": ["metric.telemetry.heartbeat=False"],
    "step_annotation": ["metric.telemetry.step_annotation=False"],
    "timer": ["metric.disable_timer=True"],
    "enabled": ["metric.telemetry.enabled=False"],
}


@pytest.mark.parametrize("off", list(SWITCHES))
def test_each_telemetry_switch_turns_its_part_off(off, tmp_path, capsys):
    """Each switch turns off its own part and no other: the stream file,
    the startup heartbeat, the iteration's profiler range, the spans' host
    seconds; ``enabled=False`` turns off the stream, the ranges and the log
    record, and leaves the heartbeat (a run on the host is never silent)."""
    from sheeprl_tpu_torch.config import compose

    telem = Telemetry(compose("config", ["exp=dreamer_v3", *SWITCHES[off]]), str(tmp_path), tracker=SpanTracker())
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        telem.tick(8)
        with telem.span("Time/train_time"):
            torch.ones(4) + 1
        telem.tick(16)
    rec = telem.log(16)
    telem.close(16)
    on = {
        "jsonl": (tmp_path / "telemetry.jsonl").is_file(),
        "heartbeat": "[telemetry rank=0] platform=cpu" in capsys.readouterr().err,
        "step_annotation": "train#8" in {e.key for e in prof.key_averages()},
        "timer": "Time/train_time" in rec.get("spans", {}),
        "enabled": bool(rec),
    }
    want = {k: k != off for k in on}
    if off == "enabled":
        want.update(jsonl=False, step_annotation=False, timer=False)
    assert on == want


def test_jsonl_sink_rotation(tmp_path):
    """Past ``max_bytes`` the live file rolls to ``telemetry.jsonl.1``,
    ``.2``, ...; every fresh segment opens with a ``rotate`` record naming
    the segment it closed; no event is lost; a sink opened again on the same
    path numbers on from the last segment."""
    path = str(tmp_path / "telemetry.jsonl")
    sink = JsonlSink(path, max_bytes=400)
    recs = [{"event": "metrics", "step": i, "metrics": {"a": float(i)}} for i in range(30)]
    for r in recs:
        sink.write(r)
    sink.close()
    segments = sorted(p for p in tmp_path.iterdir() if p.name.startswith("telemetry.jsonl."))
    assert len(segments) >= 3
    assert [p.name for p in segments] == [f"telemetry.jsonl.{i}" for i in range(1, len(segments) + 1)]
    seen = []
    for i, p in enumerate(segments + [tmp_path / "telemetry.jsonl"]):
        _both_validate(p)
        ev = _events(p)
        if i > 0:
            assert ev[0] == {"event": "rotate", "segment": i, "path": str(segments[i - 1])}
            ev = ev[1:]
        assert p.stat().st_size <= 400 + 80
        seen += ev
    assert seen == recs
    again = JsonlSink(path, max_bytes=1)
    again.write(recs[0])
    again.close()
    assert (tmp_path / f"telemetry.jsonl.{len(segments) + 1}").exists()


def test_tensorboard_logger_falls_back_to_jsonl(tmp_path, monkeypatch):
    """Where ``torch.utils.tensorboard`` does not import (the card's machine
    has no tensorboard), the logger writes its scalars to
    ``<log_dir>/metrics_fallback.jsonl`` as ``metrics`` events both packages
    validate; where it imports, it writes event files."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)  # the import fails
    with pytest.warns(RuntimeWarning, match="fallback"):
        monkeypatch.setattr("sheeprl_tpu_torch.utils.logger._tb_import_warned", False)
        logger = TensorBoardLogger(str(tmp_path / "fb"))
    assert not logger.available
    logger.log_metrics({"Loss/a": 1.5, "Time/sps": np.float32(2.0), "note": "not a number"}, 8)
    logger.log_metrics({"Loss/a": 0.5}, 16)
    logger.close()
    path = tmp_path / "fb" / "metrics_fallback.jsonl"
    _both_validate(path)
    assert _events(path) == [{"event": "metrics", "step": 8, "metrics": {"Loss/a": 1.5, "Time/sps": 2.0}},
                             {"event": "metrics", "step": 16, "metrics": {"Loss/a": 0.5}}]
    monkeypatch.delitem(sys.modules, "torch.utils.tensorboard")
    tb = TensorBoardLogger(str(tmp_path / "tb"))
    assert tb.available
    tb.log_metrics({"Loss/a": 1.0}, 1)
    tb.close()
    assert any(p.name.startswith("events.out.tfevents") for p in (tmp_path / "tb").iterdir())


def test_logger_and_facade_refuse_what_is_not_ported(tmp_path):
    from sheeprl_tpu_torch.config import compose

    with pytest.raises(NotImplementedError, match="mlflow"):
        get_logger(compose("config", ["exp=dreamer_v3", "metric.logger=mlflow"]), str(tmp_path))
    assert get_logger(compose("config", ["exp=dreamer_v3", "metric.log_level=0"]), str(tmp_path)) is None
    with pytest.raises(NotImplementedError, match="prometheus"):
        Telemetry(compose("config", ["exp=dreamer_v3", "metric.telemetry.prometheus_port=9100"]), str(tmp_path))


def test_span_tracker_drains_and_nests():
    tracker = SpanTracker()
    with tracker.span("Time/train_time"):
        assert tracker.current() == "Time/train_time"
        with tracker.span("Time/train_time/inner"):
            assert tracker.depth() == 2
    with tracker.span("Time/train_time"):
        pass
    assert tracker.counts() == {"Time/train_time/inner": 1, "Time/train_time": 2}
    totals = tracker.compute(reset=True)
    assert set(totals) == {"Time/train_time", "Time/train_time/inner"} and totals["Time/train_time"] >= 0
    assert tracker.compute() == {} and tracker.depth() == 0


def test_span_opens_a_profiler_range():
    tracker = SpanTracker()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with tracker.span("Time/env_interaction_time"):
            torch.ones(4) + 1
    assert "Time/env_interaction_time" in {e.key for e in prof.key_averages()}


def test_throughput_and_roofline_match_the_reference():
    """The interval arithmetic, MFU and the roofline record are the
    reference's on the same inputs; the peak table's row for the H100 SXM
    gives its f32 and bf16 peaks and HBM bandwidth."""
    h100 = "NVIDIA H100 80GB HBM3"
    rec = throughput.peak_record(h100, "32-true")
    assert (rec["peak_flops"], rec["peak_bytes_per_s"]) == (67e12, 3.35e12)
    assert throughput.peak_record(h100, "bf16-mixed")["peak_flops"] == 989e12
    assert throughput.peak_record("Some other card", "32-true")["peak_flops"] is None
    assert throughput.mfu(2e9, 10.0, 67e12) == jax_throughput.mfu(2e9, 10.0, 67e12)
    cost = {"flops": 3.0e11, "bytes_accessed": 2.0e9}
    for calls in (None, 12.5):
        got = throughput.roofline_record("train_step", cost, 67e12, 3.35e12, calls, device_kind=h100, role="learner")
        want = jax_throughput.roofline_record("train_step", cost, 67e12, 3.35e12, calls, device_kind=h100,
                                              role="learner")
        got.pop("t"), want.pop("t")
        assert got == want
        assert schema.validate_event(got) == []
    mine, ref = throughput.ThroughputTracker(), jax_throughput.ThroughputTracker()
    for t in (mine, ref):
        t.set_model_flops(1e9, 1e12)
        t.record_grad_steps(4)
    a, b = mine.mark(40), ref.mark(40)
    assert a["interval_steps"] == b["interval_steps"] == 40 and a["replay_ratio"] == b["replay_ratio"] == 0.1
    assert a["mfu"] == pytest.approx(1e9 * a["grad_steps_per_s"] / 1e12)
    assert mine.total_grad_steps == 4


def test_model_cost_counts_forward_and_backward():
    """One step of a linear layer and its gradients: 2·M·K·N operations for
    the forward and 4·M·K·N for the backward (input and weight gradients);
    the bytes are at least the operands read once and the result written."""
    M, K, N = 32, 16, 8
    lin = torch.nn.Linear(K, N, bias=False)
    x = torch.randn(M, K, requires_grad=True)
    _, cost = throughput.model_cost(lambda: lin(x).sum().backward())
    assert cost["flops"] == 6 * M * K * N
    assert cost["bytes_accessed"] >= 4 * (M * K + K * N + M * N)


def test_memory_sampler_records_host_memory():
    got = []
    sampler = MemorySampler(got.append, role="learner", interval_s=60.0, step_fn=lambda: 7)
    rec = sampler.sample_once()
    assert got == [rec] and rec["step"] == 7 and rec["rss_bytes"] > 0
    assert schema.validate_event(rec) == [] and jax_schema.validate_event(rec) == []
    assert "hbm_bytes_in_use" not in memory_snapshot()  # no device fields on the host
    sampler.start().stop()
    assert len(got) == 2 and sampler.rss_high_water > 0


def test_device_counters_count_host_to_device_copies():
    before = device_counters.counters()
    device_counters.record_h2d(torch.zeros(4, 8), np.zeros(3, np.uint8))
    diff = device_counters.delta(device_counters.counters(), before)
    assert (diff["h2d_calls"], diff["h2d_bytes"]) == (1, 4 * 32 + 3)
    assert set(diff["ln_gru_launches"]) == {"ln_gru_xproj", "ln_gru_fwd", "ln_gru_bwd", "ln_gru_dx", "ln_gru_wgrad"}


class _Events:
    def __init__(self):
        self.events = []

    def emit(self, rec):
        self.events.append(rec)


def test_runguard_emits_resume_and_preempt_events(tmp_path):
    """The RunGuard's events where the reference's are: ``resume`` at setup
    when ``checkpoint.resume_from`` is set, ``preempt`` requested at the
    boundary that sees the request and checkpointed once the final write
    landed; the checkpoint writer's records go to the same stream."""
    from sheeprl_tpu_torch.config import Config
    from sheeprl_tpu_torch.resilience.guard import RunGuard
    from sheeprl_tpu_torch.utils.checkpoint import CheckpointManager

    cfg = Config({"resilience": {"preemption": {"enabled": True, "signals": ["SIGTERM"], "grace_s": 30.0,
                                                "poller": {"_target_": "sheeprl_tpu_torch.resilience.preemption."
                                                           "CountdownPoller", "n": 1},
                                                "poll_every_s": 0.0},
                                 "async_checkpoint": {"enabled": True, "max_in_flight": 1},
                                 "watchdog": {"enabled": False}},
                  "algo": {"max_wall_time_s": -1}, "checkpoint": {"save_last": True, "resume_from": "ckpt_4.ckpt"},
                  "seed": 0})
    telem = _Events()
    guard = RunGuard.setup(cfg, CheckpointManager(str(tmp_path)), telem=telem)
    assert guard.stop_reached(6, 100, lambda: {"w": torch.ones(2)})
    guard.close(6)
    kinds = [(e["event"], e.get("action")) for e in telem.events]
    assert kinds[0] == ("resume", None) and ("preempt", "requested") in kinds and ("preempt", "checkpointed") in kinds
    assert ("ckpt_async", "written") in kinds
    for e in telem.events:
        assert schema.validate_event(e) == [] and jax_schema.validate_event(e) == [], e

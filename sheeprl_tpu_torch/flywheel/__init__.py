"""The data flywheel: serve-side capture → offline ingestion → fine-tune →
rolling reload, closed end to end (the port's counterpart of
``sheeprl_tpu/flywheel/``).

* capture.py — in-replica trajectory logging (schema'd JSONL segments keyed
  by the distributed-tracing ids, size-bounded rotation, per-session
  sampling);
* ingest.py — offline segment streaming into the replay buffers (torn lines
  counted, (session_id, step) exactly-once ledger, params_version stamping,
  RecordingSink op-path replay);
* recipe.py — the ``sheeprl_tpu_torch flywheel`` fine-tune recipe (staleness-aware
  gradient burst → checkpoint → the gateway's rolling reload).
"""
from .capture import CaptureWriter, capture_writer_from_spec, session_sampled
from .ingest import IngestLedger, discover_capture_streams, ingest, iter_capture_records
from .recipe import (
    FINETUNE_BUILDERS,
    build_finetune_step,
    register_finetune_builder,
    run_flywheel,
    write_checkpoint,
)

__all__ = [
    "CaptureWriter",
    "capture_writer_from_spec",
    "session_sampled",
    "IngestLedger",
    "discover_capture_streams",
    "ingest",
    "iter_capture_records",
    "FINETUNE_BUILDERS",
    "build_finetune_step",
    "register_finetune_builder",
    "run_flywheel",
    "write_checkpoint",
]

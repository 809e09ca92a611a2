"""The staged prefetcher on the card: the stream handoffs that no CPU run can
show. Marked ``cuda``: they skip without an NVIDIA GPU. This file imports
neither JAX nor the JAX package, so it also runs on a machine that has only
PyTorch:  pytest tests/test_torch_prefetch_cuda.py --noconftest

* the consumer's stream reads a staged batch only after its copy (the copy
  stream queued behind a device spin: without the wait on the copy's event
  the consumer would read the batch the slot held before);
* a batch the consumer's queued kernels still read is not overwritten: the
  consumer's stream is held behind a spin while it reads, two more stages
  follow (the second refills the slot it was handed) and its read still
  sees the old values;
* a mismatched ``g`` and the warmup boundary sample synchronously."""
import numpy as np
import pytest
import torch

from sheeprl_tpu_torch.data.prefetch import StagedPrefetcher

SPIN = 100_000_000  # device clock cycles, about 50 ms on an H100
SHAPE = (1, 64, 16, 64, 64, 3)  # one DreamerV3-S burst of frames


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the prefetcher's streams and events)")
    return torch.device("cuda", torch.cuda.current_device())


class _Source:
    """A sample function whose every batch is filled with ``value``."""

    def __init__(self):
        self.value = 0
        self.empty = False

    def __call__(self, g, out=None):
        if self.empty:
            raise ValueError("No data in the buffer, cannot sample")
        shape = (g,) + SHAPE[1:]
        if out is None:
            return {"rgb": np.full(shape, self.value, np.uint8)}
        out["rgb"].fill(self.value)
        return out


def _twice(check):
    """Run a scenario twice and check the second: the first loads every
    kernel and gives each stream its own cached memory, whose first
    allocation could otherwise synchronise the device and hide a missing
    wait."""
    check(warm=True)
    torch.cuda.synchronize()
    check(warm=False)


def _total(v: int) -> int:
    return v * int(np.prod(SHAPE))


@pytest.mark.cuda
def test_take_waits_for_the_staged_copy():
    dev = _card()
    src = _Source()
    pf = StagedPrefetcher(src, dev)

    def check(warm):
        src.value = 2 if warm else 3
        with torch.cuda.stream(pf._stream):
            torch.cuda._sleep(SPIN)  # the copy stream is busy: the copy lands late
        pf.stage(1)
        got = pf.take(1)["rgb"].sum(dtype=torch.int64)
        assert warm or int(got) == _total(src.value)

    _twice(check)


@pytest.mark.cuda
def test_a_batch_the_consumer_still_reads_is_not_overwritten():
    dev = _card()
    src = _Source()
    pf = StagedPrefetcher(src, dev)

    def check(warm):
        src.value = 5
        pf.stage(1)
        batch = pf.take(1)  # the consumer holds this slot
        torch.cuda._sleep(SPIN)  # its read is queued behind a spin
        read = batch["rgb"].sum(dtype=torch.int64)
        src.value = 7
        pf.stage(1)  # the other slot
        pf.stage(1)  # the slot the consumer still reads: waits for its release
        torch.cuda.synchronize()
        assert warm or int(read) == _total(5)
        assert int(pf.take(1)["rgb"].sum(dtype=torch.int64)) == _total(7)

    _twice(check)


@pytest.mark.cuda
def test_mismatch_and_warmup_sample_synchronously():
    dev = _card()
    src = _Source()
    pf = StagedPrefetcher(src, dev)
    src.empty = True
    pf.stage(1)  # the warmup boundary: nothing to stage
    with pytest.raises(ValueError):
        pf.take(1)
    src.empty = False
    src.value = 4
    pf.stage(1)
    src.value = 6
    got = pf.take(2)  # not the staged g: a fresh sample
    assert got["rgb"].shape[0] == 2 and int(got["rgb"].sum(dtype=torch.int64)) == 2 * _total(6)
    assert pf.copies == 2

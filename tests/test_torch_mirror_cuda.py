"""The player's ParamMirror on the card: the stream handoffs that no CPU run
can show. Marked ``cuda``: they skip without an NVIDIA GPU. This file
imports neither JAX nor the JAX package, so it also runs on a machine that
has only PyTorch:  pytest tests/test_torch_mirror_cuda.py --noconftest

* the player's stream reads a refreshed copy only after the learner's copy
  into it (the learner's stream queued behind a device spin: without the
  event wait the player would read the old values);
* a copy the player's queued kernels still read is not overwritten: the
  player's stream is held behind a spin while it reads, the learner
  refreshes twice (the second refresh writes the copy the player swapped
  away from) and the player's read still sees the old values;
* async refresh keeps the old copy until the copy's event has completed;
* the host player's copy lands in pinned memory."""
import pytest
import torch

from sheeprl_tpu_torch.parallel.placement import ParamMirror

SPIN = 100_000_000  # device clock cycles, about 50 ms on an H100


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the mirror's streams and events)")
    return torch.device("cuda", torch.cuda.current_device())


def _learner(dev):
    torch.manual_seed(0)
    return {"wm": torch.nn.Linear(256, 256).to(dev), "actor": torch.nn.Linear(256, 4).to(dev)}


def _twice(check):
    """Run a scenario twice and check the second: the first loads every
    kernel and gives each stream its own cached memory, whose first
    allocation or module load could otherwise synchronise the device and
    hide a missing wait."""
    check(warm=True)
    torch.cuda.synchronize()
    check(warm=False)


@pytest.mark.cuda
def test_player_stream_waits_for_the_refresh_copy():
    dev = _card()
    learner = _learner(dev)
    mirror = ParamMirror(learner, dev)
    player = torch.cuda.Stream(dev)

    def check(warm):
        value = 2.0 if warm else 3.0
        with torch.no_grad():
            learner["wm"].weight.fill_(value)
        torch.cuda._sleep(SPIN)  # the learner's stream is busy: the copy lands late
        mirror.refresh(learner)
        with torch.cuda.stream(player):
            got = mirror.current()["wm"].weight.sum()
        player.synchronize()
        assert warm or float(got) == value * 256 * 256

    _twice(check)


@pytest.mark.cuda
def test_a_copy_the_player_still_reads_is_not_overwritten():
    dev = _card()
    learner = _learner(dev)
    mirror = ParamMirror(learner, dev)
    player = torch.cuda.Stream(dev)

    def check(warm):
        with torch.no_grad():
            learner["wm"].weight.fill_(1.0)
        mirror.refresh(learner)
        with torch.cuda.stream(player):
            cur = mirror.current()  # slot A, holding 1.0
            torch.cuda._sleep(SPIN)  # the player's read is queued behind a spin
            read = cur["wm"].weight * 1.0
        with torch.no_grad():
            learner["wm"].weight.fill_(2.0)
        mirror.refresh(learner)  # writes slot B
        with torch.cuda.stream(player):
            mirror.current()  # swaps to B, releases A after the queued read
        with torch.no_grad():
            learner["wm"].weight.fill_(5.0)
        mirror.refresh(learner)  # writes A again: must wait for the player's read
        player.synchronize()
        torch.cuda.synchronize()
        assert warm or (float(read.min()) == 1.0 and float(read.max()) == 1.0)
        with torch.cuda.stream(player):
            assert float(mirror.current()["wm"].weight.min()) == 5.0

    _twice(check)


@pytest.mark.cuda
def test_async_refresh_swaps_once_the_copy_has_landed():
    dev = _card()
    learner = _learner(dev)
    mirror = ParamMirror(learner, dev, async_refresh=True)
    player = torch.cuda.Stream(dev)
    with torch.cuda.stream(player):
        old = mirror.current()
    with torch.no_grad():
        learner["actor"].bias.fill_(7.0)
    torch.cuda._sleep(SPIN)
    mirror.refresh(learner)
    with torch.cuda.stream(player):
        assert mirror.current() is old  # the copy is still queued behind the spin
    torch.cuda.synchronize()
    with torch.cuda.stream(player):
        new = mirror.current()
        assert new is not old and float(new["actor"].bias.min()) == 7.0


@pytest.mark.cuda
def test_host_player_refresh_lands_in_pinned_memory():
    dev = _card()
    learner = _learner(dev)
    mirror = ParamMirror(learner, torch.device("cpu"))
    with torch.no_grad():
        learner["wm"].weight.fill_(4.0)
    torch.cuda._sleep(SPIN)
    mirror.refresh(learner)
    cur = mirror.current()  # waits for the device-to-host copy's event
    assert cur["wm"].weight.is_pinned() and float(cur["wm"].weight.min()) == 4.0
    assert mirror.stats()["player_wait_ms"] > 0.0

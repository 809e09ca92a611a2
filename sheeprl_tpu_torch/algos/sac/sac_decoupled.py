"""``sac_decoupled`` (counterpart of ``sheeprl_tpu/algos/sac/sac_decoupled.py``):
registered as a decoupled algorithm, so ``check_configs`` refuses it on fewer
than two devices (``fabric.devices >= 2``) with the JAX package's message.
Its player/trainer loop needs the device mesh, which the port does not have
yet; its checkpoints hold SAC's tree, so ``eval`` takes them through SAC's
evaluation."""
from __future__ import annotations

from ...config import Config
from ...utils.registry import register_algorithm, register_evaluation
from .sac import evaluate_sac


@register_algorithm(name="sac_decoupled", decoupled=True)
def main(cfg: Config) -> None:
    raise NotImplementedError("sac_decoupled: the decoupled player/trainer loop needs the device mesh, which the "
                              "PyTorch port does not have yet (it trains on one device)")


register_evaluation("sac_decoupled")(evaluate_sac)

#!/bin/bash
# A/B of DreamerV3-S's CLI legs between two checkouts of the port on one
# card: chip_smoke.py phase run's `run` (overlapped) and `serial` legs, in
# turns (A, B, B, A), each checkout's LN-GRU kernels built first. Prints one
# line a leg: the checkout, the leg, the exit code, its seconds and the
# run's last `step=... sps=...` (policy steps/s over the whole run).
# Usage: bash scripts/torch_dv3_legs_ab.sh <checkout A> <checkout B>
A=$(cd "$1" && pwd); B=$(cd "$2" && pwd)
ARGS="exp=dreamer_v3 env=dummy algo.world_model.decoupled_rssm=True algo.world_model.pallas_gru=True env.num_envs=2
algo.per_rank_sequence_length=64 algo.per_rank_batch_size=16 algo.learning_starts=128 algo.replay_ratio=0.5
buffer.size=1024 metric.log_every=32 checkpoint.every=96 checkpoint.save_last=True algo.run_test=False
algo.total_steps=256"
OUT=$(mktemp -d)
for tree in "$A" "$B"; do (cd "$tree" && python -c "from sheeprl_tpu_torch.ops import ln_gru; ln_gru.build()" > /dev/null 2>&1); done
for tree in "$A" "$B" "$B" "$A"; do
  for leg in run serial; do
    extra=""; [ $leg = serial ] && extra="algo.overlap.enabled=False"
    s=$(date +%s.%N)
    (cd "$tree" && python -m sheeprl_tpu_torch run $ARGS $extra run_name=$leg root_dir="$OUT/runs" > "$OUT/out.txt" 2>&1)
    rc=$?
    e=$(date +%s.%N)
    echo "$tree $leg rc=$rc seconds=$(python3 -c "print(round($e - $s, 2))") $(grep -o 'step=[0-9]* sps=[0-9.]*' "$OUT/out.txt" | tail -1)"
  done
done
rm -rf "$OUT"

#!/bin/sh
# Regenerate the port's best-config table on the card: the card sweep
# (singa_tpu_torch/tools/autotune.py CARD_SWEEP and CARD_GRIDS, the
# sweep's defaults on the card) of the serve and the train domain, each
# fitted, its measured argbest written to the table beside the card's
# name and power limit.  Run from the repository's root on a machine
# with the card:
#
#     sh singa_tpu_torch/autotune/card_sweep.sh [STORE [TABLE]]
#
# STORE defaults to the autotuner's store (runs/torch/autotune.jsonl),
# TABLE to the committed table.
set -e
STORE=${1:-runs/torch/autotune.jsonl}
TABLE=${2:-singa_tpu_torch/autotune/data/best.json}
CARD=$(nvidia-smi --query-gpu=name,power.limit --format=csv,noheader \
       | head -n 1)
AT="python3 -m singa_tpu_torch.tools.autotune"
for DOMAIN in serve train; do
    $AT sweep --domain $DOMAIN --device cuda --store "$STORE"
    $AT fit --domain $DOMAIN --platform cuda --store "$STORE" \
        --table "$TABLE" --card "$CARD" --update-best
done
$AT check --store "$STORE" --table "$TABLE"

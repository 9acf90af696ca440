#!/bin/bash
# Run every annotation policy on the MOSE test split with the PyTorch port, on
# the card (eval_annotation_method's --device default; reference
# scripts/eval_mose.sh).
set -e
DB=MOSE
ROUNDS=${ROUNDS:-60}
PY="python -m eva_vos_tpu_torch.cli.eval_annotation_method --db $DB --rounds $ROUNDS"

$PY --policy rand_mask
$PY --policy oracle_mask
$PY --policy qnet_mask
$PY --policy upper_bound_mask
$PY --policy l2_mask --encoder resnet101
$PY --policy l2_mask --encoder vit_large
$PY --policy l2_mask --encoder dino_large
$PY --policy rand_type --types 3clicks
$PY --policy rand_rand --types 3clicks mask
$PY --policy oracle_oracle --types 3clicks mask
$PY --policy eva_vos

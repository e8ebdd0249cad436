#!/bin/bash
# Two-stage online sAP pipeline of the port: detect under the wall clock,
# then pair and evaluate (fps 30, input scale 0.5, eta 0). Run from the
# repository root; extra arguments go to stream_det (e.g. --device-preproc).
set -e

DATA_ROOT="${DATA_ROOT:-/data/Argoverse-1.1/tracking}"
ANNOT_PATH="${ANNOT_PATH:-/data/Argoverse-HD/annotations/val.json}"
FPS="${FPS:-30}"
CONFIG="${1:?usage: streamyolo.sh CONFIG WEIGHTS OUT_DIR [stream_det flags]}"
WEIGHTS="${2:?usage: streamyolo.sh CONFIG WEIGHTS OUT_DIR [stream_det flags]}"
OUT_DIR="${3:?usage: streamyolo.sh CONFIG WEIGHTS OUT_DIR [stream_det flags]}"
shift 3

python -m streamyolo_torch.tools.stream_det \
  --data-root "$DATA_ROOT" \
  --annot-path "$ANNOT_PATH" \
  --fps "$FPS" \
  --in_scale 0.5 \
  --config "$CONFIG" \
  --weights "$WEIGHTS" \
  --out-dir "$OUT_DIR" \
  --overwrite "$@"

python -m streamyolo_torch.tools.streaming_eval \
  --annot-path "$ANNOT_PATH" \
  --result-dir "$OUT_DIR" \
  --fps "$FPS" \
  --eta 0 \
  --overwrite

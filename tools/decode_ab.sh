#!/usr/bin/env bash
# Decode A/B between two or three checkouts on one card, in one call:
#
#   bash tools/decode_ab.sh PARENT [OTHER]
#
# PARENT (A) and OTHER (C) are checkouts unpacked with `git archive` into
# a directory .gitignore lists (build/ab/...); B is this checkout. Builds
# flash_attn in each at once, then runs `tools/port_ab.py --only
# decode,lm` in turns A B B A (then C), appending one JSON line a run to
# chiprun_out/ab.jsonl, and prints a summary line a run.
set -x
parent=${1:-build/ab/parent}
other=${2:-}
mkdir -p chiprun_out
for r in "$parent" . $other; do
  python3 -c "import sys; sys.path.insert(0, '$r/src'); from repro_torch.kernels import _build; _build.build_all(['flash_attn'])" &
done
wait
runs=("$parent A" ". B" ". B" "$parent A")
if [ -n "$other" ]; then runs+=("$other C"); fi
for x in "${runs[@]}"; do
  set -- $x
  python3 tools/port_ab.py --root "$1" --label "$2" --only decode,lm \
    >> chiprun_out/ab.jsonl || echo "FAIL $2"
done
python3 - <<'PY'
import json
for line in open("chiprun_out/ab.jsonl"):
    r = json.loads(line)
    d, l = r["decode"], r["lm"]
    print(r["label"], r["nvidia_smi"],
          [(x["shape"][4], round(x["ms"], 4), round(x["host_us"], 1),
            round(x["host_us_cuda_flavor"], 1), round(x["sdpa_ms"], 4))
           for x in d],
          round(l["ms_per_step"], 2), round(l["tokens_per_s"], 1),
          round(l["ms_per_tick"], 2), round(l["device_ms_per_tick"], 2),
          l["flash_attn_launches"])
PY

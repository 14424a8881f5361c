#!/bin/bash
# tpukaldi decode driver: posterior arks -> WFST lattices -> scoring.
#
# Same call contract as the reference's kaldi_decoding_scripts/decode_dnn.sh
# (invoked by tpukaldi.decode.bridge.run_decode):
#
#     decode_dnn.sh <decoding.conf> <out_dir> "<ark1> <ark2> ..."
#
# The conf is the [decoding] section written by write_decoding_conf:
# latgen knobs (min_active/max_active/max_mem/beam/latbeam/acwt), the
# derived alidir/data/graphdir paths, and optional scoring_script /
# scoring_opts / skip_scoring.  One latgen-faster-mapped job runs per
# posterior ark (they are independent chunks), in parallel, exactly the
# reference's chunk-level decode parallelism; scoring then sweeps LM
# weights.  Requires Kaldi binaries on PATH (latgen-faster-mapped,
# lattice-best-path, compute-wer).
set -u

conf=$1
dir=$(echo "$2" | sed 's:/*$::')
arks=$3

# defaults (proto/decoding.proto values); the conf overrides
min_active=200
max_active=7000
max_mem=50000000
beam=13.0
latbeam=8.0
acwt=0.10
skip_scoring=false
scoring_script=
scoring_opts=
alidir=
data=
graphdir=

# load "key = value" conf lines as shell variables WITHOUT eval: an
# unquoted multi-word value (scoring_opts = --min-lmwt 1 ...) or a path
# with spaces must stay one assignment, never word-split into a command.
# Only whitelisted keys are accepted — a stray cfg key named `dir`/`arks`/
# `PATH` must never clobber script state (the reference's source-based
# loader had exactly that flaw)
while IFS= read -r line; do
  key=${line%%=*}
  value=${line#*=}
  case "$value" in
    \"*\") value=${value%\"}; value=${value#\"} ;;
  esac
  case "$key" in
    min_active|max_active|max_mem|beam|latbeam|acwt|alidir|data|graphdir|scoring_script|scoring_opts|skip_scoring)
      printf -v "$key" '%s' "$value" ;;
    *) ;;  # ignore unknown keys (e.g. threads, norm_vars passthroughs)
  esac
done < <(grep -E '^[A-Za-z_][A-Za-z_0-9]* *=' "$conf" | sed 's/ *= */=/')

for f in "$graphdir/HCLG.fst" "$graphdir/words.txt" "$alidir/final.mdl"; do
  [ -f "$f" ] || { echo "$0: missing $f" >&2; exit 1; }
done

mkdir -p "$dir/log"

job=0
pids=()
for ck in $arks; do
  job=$((job + 1))
  latgen-faster-mapped \
    --min-active=$min_active --max-active=$max_active --max-mem=$max_mem \
    --beam=$beam --lattice-beam=$latbeam --acoustic-scale=$acwt \
    --allow-partial=true --word-symbol-table="$graphdir/words.txt" \
    "$alidir/final.mdl" "$graphdir/HCLG.fst" \
    "ark,s,cs: cat $ck |" "ark:|gzip -c > $dir/lat.$job.gz" \
    &> "$dir/log/decode.$job.log" &
  pids+=($!)
done

rc=0
for p in "${pids[@]}"; do
  wait "$p" || rc=1
done
[ $rc -eq 0 ] || { echo "$0: a latgen job failed (see $dir/log)" >&2; exit 1; }

echo $job > "$dir/num_jobs"
# keep the acoustic model next to the decode dir for scorers that expect it
cp "$alidir/final.mdl" "$(dirname "$dir")/" 2>/dev/null || true

case "$skip_scoring" in
  true|True) exit 0 ;;
esac

here=$(cd "$(dirname "$0")" && pwd)
scorer=$scoring_script
if [ -n "$scorer" ] && [ ! -x "$scorer" ]; then
  # pick the phone-folding fallback when the data tree carries a TIMIT
  # phone map (the 48->39 protocol of the reference's local/score.sh);
  # otherwise the generic word scorer — and never swap silently
  if [ -f "$data/../phones.60-48-39.map" ] || [ -f "$data/phones.60-48-39.map" ]; then
    fallback="$here/score_per.sh"
  else
    fallback="$here/score_wer.sh"
  fi
  echo "$0: WARNING: scoring_script '$scorer' not found/executable;" \
       "falling back to $fallback (results may not be comparable to the" \
       "recipe's scoring protocol)" >&2
fi
if [ -z "$scorer" ] || [ ! -x "$scorer" ]; then
  if [ -f "$data/../phones.60-48-39.map" ] || [ -f "$data/phones.60-48-39.map" ]; then
    scorer="$here/score_per.sh"
  else
    scorer="$here/score_wer.sh"
  fi
fi
# shellcheck disable=SC2086  # scoring_opts is intentionally word-split
"$scorer" $scoring_opts "$data" "$graphdir" "$dir"

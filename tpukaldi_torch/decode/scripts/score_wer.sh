#!/bin/bash
# Word-error-rate scoring over an LM-weight sweep (the generic scorer the
# reference reaches through scoring_script=local/score.sh on word tasks):
#
#     score_wer.sh [--min-lmwt N] [--max-lmwt M] <data> <graph> <decode_dir>
#
# For each LM weight: best path through the lattices, int->word mapping via
# the graph's words.txt, then compute-wer against <data>/text, producing
# the wer_<lmwt> files tpukaldi.decode.harvest_wer reads (%WER line with
# ins/del/sub detail).  TIMIT-style phone scoring with sclite stays
# delegated to a user-supplied scoring_script.
set -u

min_lmwt=1
max_lmwt=10
while [ $# -gt 3 ]; do
  case "$1" in
    --min-lmwt) min_lmwt=$2; shift 2 ;;
    --max-lmwt) max_lmwt=$2; shift 2 ;;
    *) shift ;;
  esac
done

data=$1
graph=$2
dir=$3
symtab=$graph/words.txt

for f in "$symtab" "$data/text" "$dir/num_jobs"; do
  [ -f "$f" ] || { echo "$0: missing $f" >&2; exit 1; }
done

nj=$(cat "$dir/num_jobs")
mkdir -p "$dir/scoring/log"
# drop stale wer files from a previous scoring run in the same decode dir
# (run_exp deliberately re-decodes into the same folder on restart): the
# sweep's exit status and the harvested files must reflect only THIS run
rm -f "$dir"/wer_*

lats=""
for j in $(seq 1 "$nj"); do lats="$lats $dir/lat.$j.gz"; done

rc=0
for lmwt in $(seq "$min_lmwt" "$max_lmwt"); do
  lattice-best-path --lm-scale=$lmwt --word-symbol-table="$symtab" \
    "ark:gunzip -c $lats |" "ark,t:$dir/scoring/$lmwt.tra" \
    2> "$dir/scoring/log/best_path.$lmwt.log" || { rc=1; continue; }
  # integer transcript -> words (inverse symbol table, pure awk)
  awk -v sym="$symtab" '
    BEGIN { while ((getline line < sym) > 0) { split(line, a, " "); m[a[2]] = a[1] } }
    { out = $1; for (i = 2; i <= NF; i++) out = out " " m[$i]; print out }
  ' "$dir/scoring/$lmwt.tra" > "$dir/scoring/$lmwt.hyp"
  compute-wer --text --mode=present \
    "ark:$data/text" "ark:$dir/scoring/$lmwt.hyp" \
    > "$dir/wer_$lmwt" 2> "$dir/scoring/log/score.$lmwt.log" || rc=1
done
# one bad LM weight must not discard the sweep: succeed when at least one
# wer file exists (the harvest picks the best line); fail only when the
# whole sweep produced nothing
if ls "$dir"/wer_* > /dev/null 2>&1; then
  [ $rc -ne 0 ] && echo "$0: WARNING: some LM weights failed (see" \
    "$dir/scoring/log); scoring continues over the successful ones" >&2
  exit 0
fi
exit $rc

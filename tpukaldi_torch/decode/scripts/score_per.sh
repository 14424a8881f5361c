#!/bin/bash
# TIMIT-protocol phone-error-rate scoring with 48->39 phone folding
# (reference kaldi_decoding_scripts/local/score.sh:33-40 +
# timit_norm_trans.pl), self-contained over base Kaldi binaries — no
# sctk/hubscr needed:
#
#   score_per.sh [--min-lmwt N] [--max-lmwt M] \
#                [--phone-map FILE] [--from 48] [--to 39] \
#                [--keep-sil] <data> <graph> <decode_dir>
#
# Per LM weight: best path through the lattices, int->phone mapping via the
# graph's words.txt (TIMIT "words" ARE phones), fold through the
# phones.60-48-39.map columns, drop phones the map deletes at the target
# inventory (e.g. q at 39) plus — by default — the silence phone (the
# reference's stm marks sil optional `(sil)`; compute-wer has no optional
# tokens, so removing sil from BOTH hyp and ref is the closest
# Levenshtein-equivalent), then compute-wer against the folded $data/text.
# Emits the wer_<lmwt> files tpukaldi.decode.harvest_wer reads.
set -u

min_lmwt=1
max_lmwt=10
phone_map=
from_col=48
to_col=39
keep_sil=false
while [ $# -gt 3 ]; do
  case "$1" in
    --min-lmwt) min_lmwt=$2; shift 2 ;;
    --max-lmwt) max_lmwt=$2; shift 2 ;;
    --phone-map) phone_map=$2; shift 2 ;;
    --from) from_col=$2; shift 2 ;;
    --to) to_col=$2; shift 2 ;;
    --keep-sil) keep_sil=true; shift ;;
    *) shift ;;
  esac
done

data=$1
graph=$2
dir=$3
symtab=$graph/words.txt
if [ -z "$phone_map" ]; then
  for cand in "$data/phones.60-48-39.map" "$data/../phones.60-48-39.map" \
              "$data/conf/phones.60-48-39.map"; do
    [ -f "$cand" ] && { phone_map=$cand; break; }
  done
fi

for f in "$symtab" "$data/text" "$dir/num_jobs" "$phone_map"; do
  [ -f "$f" ] || { echo "$0: missing $f" >&2; exit 1; }
done

nj=$(cat "$dir/num_jobs")
mkdir -p "$dir/scoring/log"
rm -f "$dir"/wer_*

# column indices inside the map file for the source/target inventories
# (phones.60-48-39.map columns are: 60 48 39)
col_of() { case "$1" in 60) echo 1 ;; 48) echo 2 ;; 39) echo 3 ;; *) echo 0 ;; esac; }
fc=$(col_of "$from_col"); tc=$(col_of "$to_col")
[ "$fc" != 0 ] && [ "$tc" != 0 ] || { echo "$0: --from/--to must be 60/48/39" >&2; exit 1; }

# fold_trans <in >out : first field is the utt id, remaining fields are
# phones mapped from column $fc to column $tc; phones with an empty target
# entry are deleted; sil dropped unless --keep-sil
fold() {
  awk -v map="$phone_map" -v fc="$fc" -v tc="$tc" -v keepsil="$keep_sil" '
    BEGIN {
      while ((getline line < map) > 0) {
        n = split(line, a, /[ \t]+/)
        if (n == 0 || a[1] == "") continue
        m[a[fc]] = (n >= tc) ? a[tc] : ""
      }
    }
    {
      out = $1
      for (i = 2; i <= NF; i++) {
        p = ($i in m) ? m[$i] : $i
        if (p == "") continue
        if (keepsil != "true" && p == "sil") continue
        out = out " " p
      }
      print out
    }'
}

fold < "$data/text" > "$dir/scoring/ref_${to_col}phn"

lats=""
for j in $(seq 1 "$nj"); do lats="$lats $dir/lat.$j.gz"; done

rc=0
for lmwt in $(seq "$min_lmwt" "$max_lmwt"); do
  lattice-best-path --lm-scale=$lmwt --word-symbol-table="$symtab" \
    "ark:gunzip -c $lats |" "ark,t:$dir/scoring/$lmwt.tra" \
    2> "$dir/scoring/log/best_path.$lmwt.log" || { rc=1; continue; }
  awk -v sym="$symtab" '
    BEGIN { while ((getline line < sym) > 0) { split(line, a, " "); m[a[2]] = a[1] } }
    { out = $1; for (i = 2; i <= NF; i++) out = out " " m[$i]; print out }
  ' "$dir/scoring/$lmwt.tra" | fold > "$dir/scoring/$lmwt.hyp_${to_col}phn"
  compute-wer --text --mode=present \
    "ark:$dir/scoring/ref_${to_col}phn" \
    "ark:$dir/scoring/$lmwt.hyp_${to_col}phn" \
    > "$dir/wer_$lmwt" 2> "$dir/scoring/log/score.$lmwt.log" || rc=1
done
if ls "$dir"/wer_* > /dev/null 2>&1; then
  [ $rc -ne 0 ] && echo "$0: WARNING: some LM weights failed (see" \
    "$dir/scoring/log); scoring continues over the successful ones" >&2
  exit 0
fi
exit $rc

"""Experiment configuration: INI parsing, proto validation, CLI overrides,
and typed dataclasses.

Covers the reference's config surface (utils.py:495 `check_cfg`,
`parse_fea_field`/`parse_lab_field`, `read_args_command_line`,
production-mode auto-detection, N_out auto-substitution) with the same INI
file format, but parses once into dataclasses instead of passing raw
ConfigParser objects through the whole stack.
"""

from __future__ import annotations

import configparser
import os
import re
import shutil
import subprocess
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from . import protos
from .model_dsl import ModelStatement, parse_model, validate_model
from .schema import ConfigError, expand_multiline_field, to_bool, validate_section
from .scheduler import expand_layerwise_schedule, expand_schedule

# ---------------------------------------------------------------------------
# dataclasses
# ---------------------------------------------------------------------------


@dataclass
class FeatureSpec:
    name: str
    lst: str  # scp list path
    opts: str  # fea_opts pipeline string
    cw_left: int
    cw_right: int

    @property
    def spliced_factor(self) -> int:
        return self.cw_left + self.cw_right + 1


@dataclass
class LabelSpec:
    name: str
    folder: str
    opts: str
    count_file: str = "auto"
    data_folder: str = ""
    graph: str = ""
    n_out: Optional[int] = None


@dataclass
class DatasetSpec:
    name: str
    section: str
    features: Dict[str, FeatureSpec]
    labels: Dict[str, LabelSpec]
    n_chunks: int
    # production decode targets: a `lab_name=none` block still carries
    # lab_data_folder / lab_graph, which the decode stage needs even though
    # no labels are loaded (reference run_exp.py:571-583)
    prod_lab: Optional[LabelSpec] = None


@dataclass
class OptimizerSpec:
    kind: str  # sgd | adam | rmsprop
    options: Dict[str, Any]


@dataclass
class ArchSpec:
    section: str
    name: str
    proto: str
    class_name: str
    library: str
    pretrain_file: str
    freeze: bool
    seq_model: bool
    lr: List[float]  # per-epoch
    halving_factor: float
    improvement_threshold: float
    optimizer: OptimizerSpec
    options: Dict[str, str]  # raw options consumed by the model constructor
    drop_field: Optional[str] = None
    drop_schedules: Optional[List[List[float]]] = None  # [layer][epoch]


@dataclass
class BatchesSpec:
    batch_size_train: List[int]  # per-epoch
    max_seq_length_train: List[Any]  # per-epoch int (or 6-int list for raw-wave)
    increase_seq_length_train: bool
    start_seq_len_train: int
    multply_factor_seq_len_train: int
    batch_size_valid: int
    max_seq_length_valid: int

    def seq_length_for_epoch(self, epoch: int) -> Any:
        """Curriculum on sequence length (utils.py:926-932,1083-1092)."""
        cap = self.max_seq_length_train[epoch]
        if not self.increase_seq_length_train:
            return cap
        if isinstance(cap, (list, tuple)):
            # raw-wave 6-tuple (size/step for fea+lab, shift, window): the
            # curriculum would replace it with a bare int and destroy the
            # sample<->frame rate relation — the reference keeps the tuple
            # and no-ops the curriculum (utils.py:1083-1092)
            return cap
        return min(
            self.start_seq_len_train
            * (self.multply_factor_seq_len_train**epoch),
            cap,
        )

    def msl_for_phase(self, phase: str, epoch: int = 0) -> Any:
        """Phase-appropriate max_seq_length.  When train uses the raw-wave
        6-tuple (different fea/lab rates), valid inherits it and forward
        keeps the rate info with splitting disabled (size -1), so the
        sample<->frame window relation survives all phases."""
        train_msl = self.max_seq_length_train[min(epoch, len(self.max_seq_length_train) - 1)]
        rates = isinstance(train_msl, (list, tuple))
        if phase == "train":
            return self.seq_length_for_epoch(epoch)
        if phase == "valid":
            return train_msl if rates else self.max_seq_length_valid
        # forward: whole utterances (data_io.py:543-544)
        if rates:
            return [-1, -1, -1, -1, train_msl[4], train_msl[5]]
        return -1


@dataclass
class ForwardSpec:
    outs: List[str]
    normalize_posteriors: List[bool]
    counts_from: List[str]
    save_out_file: List[bool]
    require_decoding: List[bool]


@dataclass
class DecodingSpec:
    script_folder: str = ""
    script: str = ""
    options: Dict[str, Any] = field(default_factory=dict)


@dataclass
class ExperimentConfig:
    cfg_file: str
    out_folder: str
    seed: int
    n_epochs: int
    run_nn_script: str
    production: bool
    datasets: Dict[str, DatasetSpec]
    train_with: List[str]
    valid_with: List[str]
    forward_with: List[str]
    batches: BatchesSpec
    archs: Dict[str, ArchSpec]  # keyed by arch_name
    model: List[ModelStatement]
    forward: ForwardSpec
    decoding: DecodingSpec
    raw: configparser.ConfigParser
    # launcher prefix for the decode command (reference run_exp.py:595
    # prepends [exp] cmd, e.g. a queue.pl/slurm wrapper)
    cmd: str = ""
    # accepted-for-compat reference flags (TPU runtime decides devices itself)
    use_cuda: bool = False
    multi_gpu: bool = False
    save_gpumem: bool = False

    def arch_for_section(self, section: str) -> ArchSpec:
        for a in self.archs.values():
            if a.section == section:
                return a
        raise KeyError(section)


# ---------------------------------------------------------------------------
# field parsing helpers
# ---------------------------------------------------------------------------


def _parse_kv_block(block: str) -> List[Dict[str, str]]:
    """Parse a multi-line `fea`/`lab` field with possibly several groups.

    Groups repeat when a key reappears (e.g. two fea_name entries in one
    dataset, README multi-feature setup).
    """
    groups: List[Dict[str, str]] = []
    current: Dict[str, str] = {}
    first_key = None
    for line in expand_multiline_field(block).split("\n"):
        line = line.strip()
        if not line:
            continue
        key, _, value = line.partition("=")
        key = key.strip()
        if first_key is None:
            first_key = key
        if key == first_key and current:
            groups.append(current)
            current = {}
        current[key] = value.strip()
    if current:
        groups.append(current)
    return groups


def parse_fea_field(block: str, strict_paths: bool = True) -> Dict[str, FeatureSpec]:
    feats: Dict[str, FeatureSpec] = {}
    for group in _parse_kv_block(block):
        name = group.get("fea_name")
        if not name:
            raise ConfigError(f"fea block missing fea_name: {group}")
        if name in feats:
            raise ConfigError(f"duplicate fea_name {name!r}")
        lst = group.get("fea_lst", "")
        if strict_paths and not os.path.isfile(lst):
            raise ConfigError(f"fea_lst {lst!r} for feature {name!r} does not exist")
        feats[name] = FeatureSpec(
            name=name,
            lst=lst,
            opts=group.get("fea_opts", ""),
            cw_left=int(group.get("cw_left", 0)),
            cw_right=int(group.get("cw_right", 0)),
        )
    return feats


def parse_lab_field(block: str, strict_paths: bool = True) -> Dict[str, LabelSpec]:
    labs: Dict[str, LabelSpec] = {}
    for group in _parse_kv_block(block):
        name = group.get("lab_name")
        if name is None:
            raise ConfigError(f"lab block missing lab_name: {group}")
        if name == "none":  # production mode marker
            continue
        folder = group.get("lab_folder", "")
        # a lab_folder may be an alignment directory OR a pre-dumped label
        # ark file (data.labels.read_label_stream resolution order)
        if strict_paths and folder and not os.path.exists(folder):
            raise ConfigError(f"lab_folder {folder!r} for label {name!r} does not exist")
        labs[name] = LabelSpec(
            name=name,
            folder=folder,
            opts=group.get("lab_opts", ""),
            count_file=group.get("lab_count_file", "auto"),
            data_folder=group.get("lab_data_folder", ""),
            graph=group.get("lab_graph", ""),
            n_out=int(group["lab_nout"]) if "lab_nout" in group else None,
        )
    return labs


def parse_prod_lab(block: str) -> Optional[LabelSpec]:
    """Extract decode targets from a `lab_name=none` production block.

    The reference derives the decode conf's data/graphdir from the
    lab_data_folder/lab_graph fields that remain in the lab block when
    lab_name=none, and alidir from graphdir's parent directory
    (run_exp.py:571-583; cfg shape: TIMIT_MLP_fbank_prod.cfg)."""
    for group in _parse_kv_block(block):
        if group.get("lab_name") == "none":
            graph = group.get("lab_graph", "")
            return LabelSpec(
                name="none",
                folder=os.path.dirname(os.path.abspath(graph)) if graph else "",
                opts="",
                count_file="none",
                data_folder=group.get("lab_data_folder", ""),
                graph=graph,
            )
    return None


# ---------------------------------------------------------------------------
# CLI overrides:  --section,field=value   |   --section,field,N,subfield="v"
# ---------------------------------------------------------------------------


def apply_overrides(config: configparser.ConfigParser, args: List[str]) -> None:
    """In-place CLI overrides with the reference's grammar
    (utils.py:63-143): 2-level replaces a field, 4-level rewrites the Nth
    `subfield=` occurrence inside a multi-line field."""
    for arg in args:
        if not arg.startswith("--") or "=" not in arg:
            raise ConfigError(f"bad override {arg!r}: expected --section,field=value")
        lhs, _, value = arg[2:].partition("=")
        value = value.strip('"')
        parts = lhs.split(",")
        section = parts[0]
        if section not in config:
            raise ConfigError(f"override {arg!r}: unknown section {section!r}")
        if len(parts) == 2:
            fld = parts[1]
            if fld not in config[section]:
                raise ConfigError(f"override {arg!r}: unknown field {fld!r} in [{section}]")
            config[section][fld] = value
        elif len(parts) == 4:
            fld, idx, sub = parts[1], int(parts[2]), parts[3]
            if fld not in config[section]:
                raise ConfigError(f"override {arg!r}: unknown field {fld!r} in [{section}]")
            current = config[section][fld]
            occurrences = list(re.finditer(re.escape(sub) + r"=[^\n]*", current))
            if idx >= len(occurrences):
                raise ConfigError(
                    f"override {arg!r}: only {len(occurrences)} {sub!r} entries present"
                )
            m = occurrences[idx]
            config[section][fld] = current[: m.start()] + f"{sub}={value}" + current[m.end():]
        else:
            raise ConfigError(f"bad override {arg!r}: wrong number of comma levels")


# ---------------------------------------------------------------------------
# N_out auto-substitution
# ---------------------------------------------------------------------------


def _n_out_from_hmm_info(folder: str, what: str) -> Optional[int]:
    """pdf/phone counts from final.mdl: native parser first
    (`..io.transition_model`), Kaldi `hmm-info` subprocess fallback
    (reference: utils.py:613-722)."""
    mdl = os.path.join(folder, "final.mdl")
    if not os.path.isfile(mdl):
        return None
    key = "number of pdfs" if what == "cd" else "number of phones"
    try:
        from ..io.transition_model import hmm_info

        return hmm_info(mdl)[key]
    except Exception:
        pass
    if not shutil.which("hmm-info"):
        return None
    out = subprocess.run(["hmm-info", mdl], capture_output=True, text=True)
    if out.returncode != 0:
        return None
    for line in out.stdout.splitlines():
        if key in line:
            return int(line.split()[-1])
    return None


def resolve_n_out(lab: LabelSpec) -> Optional[int]:
    """Output-layer size for a label stream: explicit lab_nout > count file >
    hmm-info > None (resolved later from the labels themselves)."""
    if lab.n_out is not None:
        return lab.n_out
    if lab.count_file not in ("auto", "none", "") and os.path.isfile(lab.count_file):
        from ..io.feats import load_counts

        return len(load_counts(lab.count_file))
    what = "mono" if "phone" in lab.opts else "cd"
    return _n_out_from_hmm_info(lab.folder, what)


def substitute_n_out(config: configparser.ConfigParser, labels: Dict[str, LabelSpec]):
    """Replace `N_out_<lab_name>` placeholders in all sections
    (reference: utils.py:708-722)."""
    for lab_name, lab in labels.items():
        placeholder = f"N_out_{lab_name}"
        n_out = None
        for section in config.sections():
            for key, val in config[section].items():
                if placeholder in val:
                    if n_out is None:
                        n_out = resolve_n_out(lab)
                    if n_out is None:
                        raise ConfigError(
                            f"cannot resolve {placeholder}: set lab_nout=, a "
                            f"lab_count_file, or make Kaldi hmm-info available"
                        )
                    config[section][key] = val.replace(placeholder, str(n_out))


# ---------------------------------------------------------------------------
# main loader
# ---------------------------------------------------------------------------


def read_ini(cfg_file: str) -> configparser.ConfigParser:
    if not os.path.exists(cfg_file):
        raise ConfigError(f"config file {cfg_file!r} does not exist")
    parser = configparser.ConfigParser()
    parser.read(cfg_file)
    return parser


def _dataset_sections(config: configparser.ConfigParser) -> List[str]:
    return [s for s in config.sections() if re.fullmatch(r"dataset\d+", s)]


def _arch_sections(config: configparser.ConfigParser) -> List[str]:
    return [s for s in config.sections() if s.startswith("architecture")]


def _detect_production(config, forward_with: List[str]) -> bool:
    """Production (transcription-only) mode: a forward dataset declares
    `lab_name=none` (reference: utils.py:535-555)."""
    for sec in _dataset_sections(config):
        if config[sec].get("data_name") in forward_with:
            lab_block = config[sec].get("lab", "")
            if re.search(r"lab_name\s*=\s*none", lab_block):
                return True
    return False


def _parse_arch(config, section: str, n_epochs: int) -> ArchSpec:
    sec = config[section]
    required = [k.lower() for k in protos.GLOBAL["architecture"]]
    missing_arch = [k for k in required if k not in sec]
    if missing_arch:
        raise ConfigError(f"section [{section}] missing fields {missing_arch}")
    proto_path = sec.get("arch_proto", "")
    # validate arch-specific options against the arch proto
    arch_proto = protos.resolve_proto(proto_path)["proto"]
    opt_kind = sec["arch_opt"]
    opt_proto = protos.resolve_proto(f"{opt_kind}.proto")["proto"]
    known = {k.lower() for k in list(arch_proto) + list(opt_proto)}
    options: Dict[str, str] = {}
    opt_options: Dict[str, Any] = {}
    drop_field = None
    for key, val in sec.items():
        if key == "arch_grad_clip":  # optional extension, consumed by optax
            options[key] = val
            continue
        if key.startswith("arch_"):
            continue
        if key.lower() in {k.lower() for k in opt_proto}:
            spec = {k.lower(): v for k, v in opt_proto.items()}[key.lower()]
            from .schema import make_checker

            opt_options[key] = make_checker(spec)(val, f"{section}.{key}")
            continue
        if key.lower() not in known:
            raise ConfigError(
                f"section [{section}]: field {key!r} not in proto {proto_path!r}"
            )
        options[key] = val
        # scheduled dropout: the reference substring-matches "_drop"
        # (utils.py:901), which would also catch sru_dropout/sru_rnn_dropout
        # and overwrite both from a single schedule; suffix-match keeps
        # scheduling to the per-layer *_drop lists it is meant for
        if key.endswith("_drop"):
            drop_field = key
    missing = [
        k
        for k in arch_proto
        if k.lower() not in {kk.lower() for kk in sec.keys()}
        and k not in protos.OPTIONAL_FIELDS
    ]
    if missing:
        raise ConfigError(f"section [{section}] missing arch fields {missing}")

    drop_schedules = None
    if drop_field is not None:
        drop_schedules = expand_layerwise_schedule(options[drop_field], n_epochs)
        # collapse scheduler syntax to epoch-0 values for static parsing
        options[drop_field] = ",".join(str(s[0]) for s in drop_schedules)

    return ArchSpec(
        section=section,
        name=sec["arch_name"],
        proto=proto_path,
        class_name=sec["arch_class"],
        library=sec.get("arch_library", "tpukaldi.models"),
        pretrain_file=sec["arch_pretrain_file"],
        freeze=to_bool(sec["arch_freeze"]),
        seq_model=to_bool(sec["arch_seq_model"]),
        lr=expand_schedule(sec["arch_lr"], n_epochs, cast=float),
        halving_factor=float(sec["arch_halving_factor"]),
        improvement_threshold=float(sec["arch_improvement_threshold"]),
        optimizer=OptimizerSpec(kind=opt_kind, options=opt_options),
        options=options,
        drop_field=drop_field,
        drop_schedules=drop_schedules,
    )


def load_config(
    cfg_file: str,
    overrides: Optional[List[str]] = None,
    strict_paths: bool = True,
    resolve_nout: bool = True,
) -> ExperimentConfig:
    """`strict_paths=False` / `resolve_nout=False` allow validating template
    cfgs whose data paths aren't materialized (e.g. the shipped cfg/
    examples)."""
    config = read_ini(cfg_file)
    if overrides:
        apply_overrides(config, overrides)

    # --- global-proto validation of the fixed sections
    gproto = protos.resolve_proto(
        config.get("cfg_proto", "cfg_proto", fallback="global.proto")
        if config.has_section("cfg_proto")
        else "global.proto"
    )
    for sec_name, proto_name in (
        ("exp", "exp"),
        ("data_use", "data_use"),
        ("batches", "batches"),
        ("forward", "forward"),
    ):
        if sec_name not in config:
            raise ConfigError(f"missing required section [{sec_name}]")
        proto_sec = dict(gproto.get(proto_name, {}))
        if sec_name == "exp":
            # out_folder is required in the global cfg but replaced by
            # out_info in chunk cfgs; accept either.
            proto_sec.pop("out_folder", None)
            proto_sec.pop("out_info", None)
            proto_sec.pop("to_do", None)
        validate_section(config[sec_name], proto_sec, sec_name)

    n_epochs = int(config["exp"]["n_epochs_tr"])
    exp = config["exp"]

    train_with = config["data_use"]["train_with"].split(",")
    valid_with = config["data_use"]["valid_with"].split(",")
    # `forward_with = none` disables the posterior-emission stage (the
    # analog of the reference's `lab_name = none` convention): train-only
    # experiments (e.g. pretraining a body for transfer) need no forward
    forward_field = config["data_use"]["forward_with"].strip()
    forward_with = (
        [] if forward_field.lower() == "none" else forward_field.split(",")
    )
    production = _detect_production(config, forward_with)

    # --- datasets
    datasets: Dict[str, DatasetSpec] = {}
    for sec in _dataset_sections(config):
        # config problems must surface as ConfigError, not raw KeyError
        # (the documented embeddability contract of this module)
        for req in ("data_name", "fea", "n_chunks"):
            if req not in config[sec]:
                raise ConfigError(f"[{sec}] missing required field {req!r}")
        name = config[sec]["data_name"]
        feats = parse_fea_field(config[sec]["fea"], strict_paths=strict_paths)
        lab_block = config[sec].get("lab", "")
        labs = parse_lab_field(lab_block, strict_paths=strict_paths)
        datasets[name] = DatasetSpec(
            name=name,
            section=sec,
            features=feats,
            labels=labs,
            n_chunks=int(config[sec]["n_chunks"]),
            prod_lab=parse_prod_lab(lab_block),
        )
    for group, names in (("train_with", train_with), ("valid_with", valid_with),
                         ("forward_with", forward_with)):
        for n in names:
            if n not in datasets:
                raise ConfigError(f"[data_use] {group} references unknown dataset {n!r}")

    # --- N_out substitution needs the union of labels over datasets
    all_labels: Dict[str, LabelSpec] = {}
    for ds in datasets.values():
        all_labels.update(ds.labels)
    if resolve_nout:
        substitute_n_out(config, all_labels)

    # --- batches (with scheduler syntax)
    b = config["batches"]
    mslt = b["max_seq_length_train"]
    if len(mslt.split(",")) > 1:
        max_seq_train: List[Any] = [[int(v) for v in mslt.split(",")]] * n_epochs
    else:
        max_seq_train = expand_schedule(mslt, n_epochs, cast=int)
    batches = BatchesSpec(
        batch_size_train=expand_schedule(b["batch_size_train"], n_epochs, cast=int),
        max_seq_length_train=max_seq_train,
        increase_seq_length_train=to_bool(b["increase_seq_length_train"]),
        start_seq_len_train=int(b["start_seq_len_train"]),
        multply_factor_seq_len_train=int(b["multply_factor_seq_len_train"]),
        batch_size_valid=int(b["batch_size_valid"]),
        max_seq_length_valid=int(b["max_seq_length_valid"]),
    )

    # --- architectures
    archs: Dict[str, ArchSpec] = {}
    for sec in _arch_sections(config):
        arch = _parse_arch(config, sec, n_epochs)
        if arch.name in archs:
            raise ConfigError(f"duplicate arch_name {arch.name!r}")
        archs[arch.name] = arch

    # --- model DSL
    stmts = parse_model(config["model"]["model"])
    any_ds = datasets[train_with[0]] if not production else datasets[forward_with[0]]
    validate_model(
        stmts,
        fea_names=list(any_ds.features),
        lab_names=list(all_labels) or ["none"],
        arch_names=list(archs),
    )

    # --- forward
    f = config["forward"]
    outs = f["forward_out"].split(",")

    def _bools(key):
        return [to_bool(v) for v in f[key].split(",")]

    forward = ForwardSpec(
        outs=outs,
        normalize_posteriors=_bools("normalize_posteriors"),
        counts_from=f["normalize_with_counts_from"].split(","),
        save_out_file=_bools("save_out_file"),
        require_decoding=_bools("require_decoding"),
    )

    # --- decoding (optional section)
    decoding = DecodingSpec()
    if "decoding" in config:
        d = config["decoding"]
        dec_opts = {
            k: v for k, v in d.items() if k not in (
                "decoding_script_folder", "decoding_script", "decoding_proto")
        }
        decoding = DecodingSpec(
            script_folder=d.get("decoding_script_folder", ""),
            script=d.get("decoding_script", ""),
            options=dec_opts,
        )

    return ExperimentConfig(
        cfg_file=cfg_file,
        out_folder=exp.get("out_folder", ""),
        seed=int(exp["seed"]),
        n_epochs=n_epochs,
        run_nn_script=exp.get("run_nn_script", "run_nn"),
        production=production,
        datasets=datasets,
        train_with=train_with,
        valid_with=valid_with,
        forward_with=forward_with,
        batches=batches,
        archs=archs,
        model=stmts,
        forward=forward,
        decoding=decoding,
        raw=config,
        cmd=exp.get("cmd", "").strip(),
        use_cuda=to_bool(exp.get("use_cuda", "False")),
        multi_gpu=to_bool(exp.get("multi_gpu", "False")),
        save_gpumem=to_bool(exp.get("save_gpumem", "False")),
    )

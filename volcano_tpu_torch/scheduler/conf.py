"""Scheduler configuration: actions, tiered plugin options, and the YAML
loader.

The port's copy of ``volcano_tpu/scheduler/conf.py``.  ``backend`` selects
where the solves run: ``"cuda"`` (the default: the hand-written kernels on
the card; raises when no card is present) or ``"cpu"`` (their plain
PyTorch versions).  ``mesh`` splits the batched solve's node planes into
blocks (``parallel/sharded.py`` ``resolve_mesh``): ``"off"``, ``"auto"``
(the process group's world size) or a power-of-two block count.
``mesh_hosts`` / ``mesh_host_id`` launch the multi-controller cycle
(``parallel/multihost.py``): every host runs the same global solve and
publishes only its owned task block's binds; host 0, the coordinator, also
owns statuses and enqueue admissions.  ``apply_mode`` "async" hands binds
and evictions to a background applier thread (``scheduler/apply.py``),
each fast cycle's decisions as ONE columnar segment (``store/segment.py``);
"sync", the default, applies them inline.  ``mirror_checkpoint`` names the
file a restarted scheduler restores its watch mirror from
(``fastpath/mirror.py``); ``schedule_period`` is the daemon loop's period,
kept for the conf's round trip.  ``delta: "on"`` runs the fast cycle's
event-driven micro-cycles (``scheduler/delta/``), with the token-bucket
admission (``delta_admit_qps``, ``delta_burst``), the backlog shedding
(``delta_high_watermark``, ``delta_low_watermark``) and the
``snapshot-incremental`` oracle (``delta_oracle``).

``load_conf`` reads the reference's scheduler-conf YAML
(``examples/scheduler-conf.yaml``) with its own reader of the subset such
a conf uses (``parse_yaml``: block mappings, block lists, quoted and bare
scalars with the YAML 1.1 booleans, comments), so no YAML package is
needed.  It maps the JAX package's keys onto the port's fields by these
rules, and raises ``ValueError`` naming the departure where the port has
no counterpart:

* ``backend: tpu`` -> ``"cuda"``; ``cuda`` and ``cpu`` stay; an absent
  key -> ``"cuda"``; ``host`` and ``native`` raise (the port has no object
  oracle or C++ solver tier);
* an absent ``applyMode`` -> ``"sync"`` (the JAX conf keeps None);
* ``columnarPublish: true`` is accepted; ``false`` raises (the applier
  always ships the columnar segment);
* ``exactTopK: true`` is accepted; ``false`` raises (the port's batched
  solve is always exact);
* every other key as the JAX loader reads it.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

BACKENDS = ("cuda", "cpu")
APPLY_MODES = ("sync", "async")

#: every per-callback enable flag, true by default (reference plugins/defaults.go)
_FLAG_NAMES = (
    "enabled_job_order", "enabled_job_ready", "enabled_job_pipelined",
    "enabled_task_order", "enabled_preemptable", "enabled_reclaimable",
    "enabled_queue_order", "enabled_predicate", "enabled_node_order",
)


@dataclass
class PluginOption:
    """A tier's plugin with its arguments and the callback enable flags the
    fast cycle reads (the reference defaults them all to true)."""

    name: str
    arguments: Dict[str, str] = field(default_factory=dict)
    enabled_job_order: bool = True
    enabled_job_ready: bool = True
    enabled_job_pipelined: bool = True
    enabled_task_order: bool = True
    enabled_preemptable: bool = True
    enabled_reclaimable: bool = True
    enabled_queue_order: bool = True
    enabled_predicate: bool = True
    enabled_node_order: bool = True


@dataclass
class Tier:
    plugins: List[PluginOption] = field(default_factory=list)


@dataclass
class SchedulerConf:
    actions: List[str] = field(default_factory=lambda: ["allocate", "backfill"])
    tiers: List[Tier] = field(default_factory=list)
    backend: str = "cuda"
    solve_mode: str = "auto"  # "auto" | "exact" | "batch"
    # "auto": the array-native fast cycle whenever it can express the
    # cycle, the object path otherwise; "off": the object path every cycle
    fast_path: str = "auto"
    # node blocks of the batched solve: "off", "auto" or a power of two.
    # Under an initialised process group the blocks spread over its ranks;
    # otherwise they all sit on this process's device.  Only the batched
    # solve shards (the exact solve stays on one block)
    mesh: str = "off"
    # the multi-controller launch (parallel/multihost.py): the host count
    # and this process's host id; 1 / 0 is the single controller
    mesh_hosts: int = 1
    mesh_host_id: int = 0
    # "async": binds and evictions batch through a background applier
    # thread (the reference's per-bind goroutines, cache.go:393-447), the
    # fast cycle's as one columnar segment; "sync": applied inline,
    # deterministic
    apply_mode: str = "sync"
    # seconds between cycles of a scheduler loop
    schedule_period: float = 1.0
    # the watch mirror's checkpoint file: a restarted scheduler restores
    # its row tables from it and re-reads only the objects whose resource
    # version moved (fastpath/mirror.py), instead of listing the cluster.
    # None: a full list
    mirror_checkpoint: Optional[str] = None
    # "on": event-driven micro-cycles (scheduler/delta/): the dirty rows of
    # the watch diff into row-keyed aggregates in place of the snapshot's
    # O(P) pod sweeps, with a full build on structural events; "off": every
    # cycle builds full
    delta: str = "off"
    # gangs a second admitted to the solve (a token bucket; a gang pays once
    # and stays admitted until it places or leaves); 0: unlimited
    delta_admit_qps: float = 0.0
    # the bucket's depth; 0: max(1, delta_admit_qps)
    delta_burst: int = 0
    # above this many pending gangs the lowest-priority ones are shed to a
    # Backlogged condition (never dropped) until the depth falls to the low
    # watermark; 0: no shedding
    delta_high_watermark: int = 0
    # the re-admit depth; 0: delta_high_watermark // 2
    delta_low_watermark: int = 0
    # every micro cycle also builds full and must equal it bit for bit
    delta_oracle: bool = False

    def __post_init__(self):
        self.validate()

    def validate(self) -> None:
        """Raise ValueError for a host count below 1, a host id outside
        [0, mesh_hosts) or an unknown apply mode (the JAX loader's
        checks)."""
        if self.apply_mode not in APPLY_MODES:
            raise ValueError(f"apply_mode must be one of {APPLY_MODES}, "
                             f"got {self.apply_mode!r}")
        if self.mesh_hosts < 1:
            raise ValueError(f"mesh_hosts must be >= 1, got {self.mesh_hosts}")
        if not 0 <= self.mesh_host_id < self.mesh_hosts:
            raise ValueError(f"mesh_host_id {self.mesh_host_id} outside "
                             f"[0, {self.mesh_hosts})")


def default_conf(backend: str = "cuda") -> SchedulerConf:
    """Parity with defaultSchedulerConf (KB/pkg/scheduler/util.go:31-41)."""
    return SchedulerConf(
        actions=["allocate", "backfill"],
        tiers=[
            Tier(plugins=[PluginOption("priority"), PluginOption("gang")]),
            Tier(plugins=[
                PluginOption("drf"), PluginOption("predicates"),
                PluginOption("proportion"), PluginOption("nodeorder"),
            ]),
        ],
        backend=backend,
    )


def full_conf(backend: str = "cuda") -> SchedulerConf:
    """All five actions and all seven plugins: the reference's deployed
    configuration (installer chart config/kube-batch.conf), reclaim before
    allocate so that freed capacity is claimable in the same cycle."""
    conf = default_conf(backend)
    conf.actions = ["enqueue", "reclaim", "allocate", "backfill", "preempt"]
    conf.tiers[0].plugins.append(PluginOption("conformance"))
    return conf


# -- the YAML subset of a scheduler conf ---------------------------------------

_BOOLS = {v: True for v in ("yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON")}
_BOOLS.update({v: False for v in ("no", "No", "NO", "false", "False", "FALSE",
                                  "off", "Off", "OFF")})
_NULLS = ("", "~", "null", "Null", "NULL")
_INT = re.compile(r"[-+]?(0|[1-9][0-9_]*)$")
_FLOAT = re.compile(r"[-+]?([0-9][0-9_]*)?\.[0-9_]*([eE][-+][0-9]+)?$")
#: "key: value": a quoted key or a bare one (not starting like a list item,
#: a comment or a flow or block indicator), then the rest of the line
_KEY = re.compile(r"""("(?:[^"\\]|\\.)*"|'(?:[^']|'')*'"""
                  r"""|[^\s'"#\-?:,\[\]{}&*!|>%@`][^:#]*?|-[^\s:#][^:#]*?)"""
                  r"""\s*:(?:\s+|$)(.*)$""")
_ESCAPES = {"n": "\n", "t": "\t", '"': '"', "\\": "\\"}


def _scalar(text: str, line_no: int) -> Any:
    """A scalar token (comment already allowed after it): quoted strings,
    then the YAML 1.1 nulls, booleans, ints and floats; else a string."""
    text = text.strip()
    if text[:1] in ("\"", "'"):
        q = text[0]
        out, i = [], 1
        while i < len(text):
            ch = text[i]
            if q == "'" and ch == "'":
                if text[i + 1:i + 2] == "'":
                    out.append("'")
                    i += 2
                    continue
                break
            if q == '"' and ch == "\\":
                esc = text[i + 1:i + 2]
                if esc not in _ESCAPES:
                    raise ValueError(f"line {line_no}: unsupported escape \\{esc}")
                out.append(_ESCAPES[esc])
                i += 2
                continue
            if q == '"' and ch == '"':
                break
            out.append(ch)
            i += 1
        else:
            raise ValueError(f"line {line_no}: unterminated quoted scalar")
        rest = text[i + 1:].strip()
        if rest and not rest.startswith("#"):
            raise ValueError(f"line {line_no}: text after a quoted scalar: {rest!r}")
        return "".join(out)
    cut = re.search(r"\s#", text)
    if cut:
        text = text[:cut.start()].rstrip()
    if text.startswith("#"):
        text = ""
    if text[:1] in ("[", "{", "|", ">", "&", "*", "!", "%", "@", "`"):
        raise ValueError(f"line {line_no}: {text!r} is outside the YAML subset a "
                         "scheduler conf uses (flow collections, block scalars, anchors, tags)")
    if text in _NULLS:
        return None
    if text in _BOOLS:
        return _BOOLS[text]
    if _INT.match(text):
        return int(text.replace("_", ""))
    if _FLOAT.match(text) and any(c.isdigit() for c in text):
        return float(text.replace("_", ""))
    return text


def _lines(text: str) -> List[Tuple[int, str, int]]:
    """(indent, content, line number) of every line that holds content."""
    out = []
    for no, raw in enumerate(text.splitlines(), start=1):
        if "\t" in raw[:len(raw) - len(raw.lstrip())]:
            raise ValueError(f"line {no}: tab indentation")
        body = raw.rstrip()
        content = body.lstrip(" ")
        if not content or content.startswith("#"):
            continue
        if content in ("---", "..."):
            continue
        out.append((len(body) - len(content), content, no))
    return out


def _is_item(content: str) -> bool:
    return content == "-" or content.startswith("- ")


def _block(lines, i: int, indent: int) -> Tuple[Any, int]:
    if _is_item(lines[i][1]):
        return _sequence(lines, i, indent)
    return _mapping(lines, i, indent)


def _value_after(lines, i: int, indent: int, rest: str, no: int) -> Tuple[Any, int]:
    """The value of a key (or list item) whose inline text is ``rest``:
    inline, a nested block, or a list at the key's own indentation."""
    inline = rest.strip()
    if inline and not inline.startswith("#"):
        return _scalar(inline, no), i + 1
    if i + 1 < len(lines):
        nxt_indent, nxt, _ = lines[i + 1]
        if nxt_indent > indent or (nxt_indent == indent and _is_item(nxt)):
            return _block(lines, i + 1, nxt_indent)
    return None, i + 1


def _mapping(lines, i: int, indent: int) -> Tuple[Dict[str, Any], int]:
    out: Dict[str, Any] = {}
    while i < len(lines):
        ind, content, no = lines[i]
        if ind < indent or (ind == indent and _is_item(content)):
            break
        if ind > indent:
            raise ValueError(f"line {no}: unexpected indentation")
        m = _KEY.match(content)
        if m is None:
            raise ValueError(f"line {no}: expected 'key: value', got {content!r}")
        out[_scalar(m.group(1), no)], i = _value_after(lines, i, indent, m.group(2), no)
    return out, i


def _sequence(lines, i: int, indent: int) -> Tuple[List[Any], int]:
    out: List[Any] = []
    while i < len(lines):
        ind, content, no = lines[i]
        if ind != indent or not _is_item(content):
            if ind > indent:
                raise ValueError(f"line {no}: unexpected indentation")
            break
        body = content[1:].lstrip(" ")
        if not body or body.startswith("#"):
            value, i = _value_after(lines, i, indent, "", no)
            out.append(value)
            continue
        col = indent + (len(content) - len(body))
        if _KEY.match(body):
            # "- key: value": a mapping whose keys sit at the item's column
            lines = lines[:i] + [(col, body, no)] + lines[i + 1:]
            value, i = _mapping(lines, i, col)
        elif _is_item(body):
            lines = lines[:i] + [(col, body, no)] + lines[i + 1:]
            value, i = _sequence(lines, i, col)
        else:
            value, i = _scalar(body, no), i + 1
        out.append(value)
    return out, i


def parse_yaml(text: str) -> Any:
    """The document of ``text`` under the YAML subset a scheduler conf
    uses: block mappings (a list may sit at its key's indentation), block
    lists whose items are scalars or mappings, quoted and bare scalars
    resolved as YAML 1.1 (``on`` / ``off`` / ``yes`` / ``no`` booleans,
    null, decimal ints, floats with a point), comments and a leading
    ``---``.  Flow collections, block scalars, anchors and tags raise
    ValueError.  An empty document is None, as ``yaml.safe_load``
    gives it."""
    lines = _lines(text)
    if not lines:
        return None
    value, i = _block(lines, 0, lines[0][0])
    if i < len(lines):
        raise ValueError(f"line {lines[i][2]}: content after the document")
    return value


def load_conf(text: str) -> SchedulerConf:
    """Parse a scheduler-conf YAML string (the reference's shape) under the
    mapping rules of this module's docstring."""
    data = parse_yaml(text) or {}
    if not isinstance(data, dict):
        raise ValueError("a scheduler conf is a mapping")
    conf = SchedulerConf()
    actions = data.get("actions")
    if actions:
        conf.actions = [a.strip() for a in str(actions).split(",") if a.strip()]
    tiers = []
    for tier_data in data.get("tiers") or []:
        tier = Tier()
        for p in tier_data.get("plugins") or []:
            opt = PluginOption(name=p["name"])
            opt.arguments = {str(k): str(v) for k, v in (p.get("arguments") or {}).items()}
            for flag in _FLAG_NAMES:
                yaml_key = flag.replace("enabled_", "")
                camel = "enable" + "".join(w.capitalize() for w in yaml_key.split("_"))
                if camel in p:
                    setattr(opt, flag, bool(p[camel]))
            tier.plugins.append(opt)
        tiers.append(tier)
    conf.tiers = tiers if tiers else default_conf().tiers
    backend = str(data.get("backend", "cuda"))
    if backend == "tpu":
        backend = "cuda"
    if backend in ("host", "native"):
        raise ValueError(f"backend: {backend} has no counterpart in the port (no object "
                         "oracle or C++ solver tier); use cuda, or cpu for the plain "
                         "PyTorch versions")
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of tpu, {', '.join(BACKENDS)}, got {backend!r}")
    conf.backend = backend
    conf.solve_mode = str(data.get("solveMode", conf.solve_mode))
    if "applyMode" in data:
        mode = str(data["applyMode"])
        if mode not in APPLY_MODES:
            raise ValueError(f"applyMode must be 'sync' or 'async', got {mode!r}")
        conf.apply_mode = mode
    if "columnarPublish" in data and not bool(data["columnarPublish"]):
        raise ValueError("columnarPublish: false has no counterpart in the port: the "
                         "async applier always ships the columnar segment")
    if "schedulePeriod" in data:
        conf.schedule_period = float(data["schedulePeriod"])
    if "exactTopK" in data and not bool(data["exactTopK"]):
        raise ValueError("exactTopK: false has no counterpart in the port: its batched "
                         "solve is always exact")
    if "mesh" in data:
        raw = data["mesh"]
        # YAML 1.1 reads a bare `off` as boolean False
        mesh = ("auto" if raw else "off") if isinstance(raw, bool) else str(raw)
        if mesh not in ("off", "auto") and not mesh.isdigit():
            raise ValueError(f"mesh must be 'off', 'auto' or a device count, got {mesh!r}")
        conf.mesh = mesh
    if "meshHosts" in data:
        conf.mesh_hosts = int(data["meshHosts"])
    if "meshHostId" in data:
        conf.mesh_host_id = int(data["meshHostId"])
    if "mirrorCheckpoint" in data:
        raw = data["mirrorCheckpoint"]
        conf.mirror_checkpoint = str(raw) if raw else None
    if "fastPath" in data:
        mode = str(data["fastPath"])
        if mode not in ("auto", "off"):
            raise ValueError(f"fastPath must be 'auto' or 'off', got {mode!r}")
        conf.fast_path = mode
    if "delta" in data:
        raw = data["delta"]
        # YAML 1.1 reads a bare on / off as a boolean
        mode = ("on" if raw else "off") if isinstance(raw, bool) else str(raw)
        if mode not in ("on", "off"):
            raise ValueError(f"delta must be 'on' or 'off', got {mode!r}")
        conf.delta = mode
    if "deltaAdmitQps" in data:
        conf.delta_admit_qps = float(data["deltaAdmitQps"])
    if "deltaBurst" in data:
        conf.delta_burst = int(data["deltaBurst"])
    if "deltaHighWatermark" in data:
        conf.delta_high_watermark = int(data["deltaHighWatermark"])
    if "deltaLowWatermark" in data:
        conf.delta_low_watermark = int(data["deltaLowWatermark"])
    if "deltaOracle" in data:
        conf.delta_oracle = bool(data["deltaOracle"])
    conf.validate()
    return conf


def get_plugin_arg(args: Dict[str, str], key: str,
                   default: Optional[float] = None) -> Optional[float]:
    """Numeric plugin argument lookup (reference framework/arguments.go)."""
    if key in args:
        try:
            return float(args[key])
        except ValueError:
            return default
    return default

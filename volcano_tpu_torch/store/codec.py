"""JSON wire codec for the API objects, the serialization layer of the bus.

The port's copy of ``volcano_tpu/store/codec.py``: a generic dataclass <->
JSON-dict codec driven by type hints, and the kind registry mapping the
store's kind strings to their root classes.  The StoreServer
(``store/server.py``) and the ``RemoteStore`` client (``store/client.py``)
speak it, so that the scheduler runs in its own process against an
apiserver in another.  The contract is wire equality: for equal objects
``json.dumps(encode(obj), sort_keys=True)`` equals the JAX package's byte
for byte (the port's classes keep the JAX fields), so either package's
client talks to either package's server.

The kinds are those the port has.  Job, Command, NodePool, ConfigMap and
Service come with the controllers (ROADMAP item 12); ``decode_object``
refuses them with a KeyError that says so.
"""

from __future__ import annotations

import dataclasses
import enum
import typing
from typing import Any, Dict, List, Tuple, Union

from volcano_tpu_torch.api.objects import (
    Node,
    PersistentVolume,
    PersistentVolumeClaim,
    Pod,
    PodDisruptionBudget,
    PodGroup,
    PriorityClass,
    Queue,
    StorageClass,
)
from volcano_tpu_torch.api.resource import Resource
from volcano_tpu_torch.events import ClusterEvent
from volcano_tpu_torch.leader import Lease

#: store kind string -> root dataclass (the "scheme" in client-go terms)
KIND_CLASSES: Dict[str, type] = {
    "Pod": Pod,
    "PodGroup": PodGroup,
    "Queue": Queue,
    "Node": Node,
    "PriorityClass": PriorityClass,
    "PVC": PersistentVolumeClaim,
    "PV": PersistentVolume,
    "StorageClass": StorageClass,
    "PodDisruptionBudget": PodDisruptionBudget,
    "Lease": Lease,
    "Event": ClusterEvent,
}

#: kinds of the JAX package that the port does not have yet
LATER_KINDS = frozenset({"Job", "Command", "NodePool", "ConfigMap", "Service"})


def unknown_kind(kind: str) -> str:
    """The message for a kind outside ``KIND_CLASSES``."""
    if kind in LATER_KINDS:
        return (f"unknown kind {kind!r}: the Job, Command, NodePool, ConfigMap "
                f"and Service kinds come with the controllers (ROADMAP item 12)")
    return f"unknown kind {kind!r}"


_hints_cache: Dict[type, Dict[str, Any]] = {}


def _hints(cls: type) -> Dict[str, Any]:
    h = _hints_cache.get(cls)
    if h is None:
        h = typing.get_type_hints(cls)
        _hints_cache[cls] = h
    return h


# -- encode ------------------------------------------------------------------

#: per-class field names (dataclasses.fields() derives the list anew on every
#: call; encode is the hottest function of the wire path)
_fields_cache: Dict[type, Tuple[str, ...]] = {}
#: scalar leaf types that pass through unchanged (str enums are handled
#: first: their value is the wire form)
_SCALARS = (bool, int, float, str)


def resource_fields(r: Resource) -> List[Tuple[str, Any]]:
    """A ``Resource``'s encoded form as (wire key, value) pairs in the
    encoded order: "cpu" and "mem" always, "scalars" when there are any,
    "max_task_num" when it is set."""
    out: List[Tuple[str, Any]] = [("cpu", r.milli_cpu), ("mem", r.memory)]
    if r.scalars:
        out.append(("scalars", dict(r.scalars)))
    if r.max_task_num is not None:
        out.append(("max_task_num", r.max_task_num))
    return out


def encode(obj: Any) -> Any:
    """Dataclass tree -> JSON-compatible value.  Type-directed on decode, so
    encode is purely structural; it dispatches on the exact class through
    caches."""
    if obj is None:
        return None
    cls = obj.__class__
    names = _fields_cache.get(cls)
    if names is not None:  # a cached dataclass: the common case
        return {name: encode(getattr(obj, name)) for name in names}
    if isinstance(obj, enum.Enum):
        return obj.value
    if isinstance(obj, _SCALARS):
        return obj
    if isinstance(obj, Resource):
        return dict(resource_fields(obj))
    if dataclasses.is_dataclass(obj):
        names = tuple(f.name for f in dataclasses.fields(cls))
        _fields_cache[cls] = names
        return {name: encode(getattr(obj, name)) for name in names}
    if isinstance(obj, (list, tuple)):
        return [encode(v) for v in obj]
    if isinstance(obj, dict):
        return {str(k): encode(v) for k, v in obj.items()}
    raise TypeError(f"cannot encode {type(obj).__name__}: {obj!r}")


# -- decode ------------------------------------------------------------------

#: one compiled decoder per type hint: the hint's origin and arguments are
#: read once, not once a value
_decoders: Dict[Any, Any] = {}


def _decoder(tp: Any):
    d = _decoders.get(tp)
    if d is None:
        d = _build_decoder(tp)
        _decoders[tp] = d
    return d


def _build_decoder(tp: Any):
    origin = typing.get_origin(tp)
    if origin is Union:  # Optional[X] and friends
        args = [a for a in typing.get_args(tp) if a is not type(None)]
        inner = _decoder(args[0])
        return lambda data: None if data is None else inner(data)
    if tp is Any or tp is None:
        return lambda data: data
    if origin in (list, typing.List):
        (item_tp,) = typing.get_args(tp) or (Any,)
        item = _decoder(item_tp)
        return lambda data: [item(v) for v in data or []]
    if origin in (tuple, typing.Tuple):
        args = typing.get_args(tp)
        if len(args) == 2 and args[1] is Ellipsis:
            item = _decoder(args[0])
            return lambda data: None if data is None else tuple(item(v) for v in data)
        if not args:
            return lambda data: None if data is None else tuple(data)
        items = [_decoder(a) for a in args]
        return lambda data: (None if data is None
                             else tuple(d(v) for d, v in zip(items, data)))
    if origin in (dict, typing.Dict):
        kt, vt = typing.get_args(tp) or (str, Any)
        kd, vd = _decoder(kt), _decoder(vt)
        return lambda data: {kd(k): vd(v) for k, v in (data or {}).items()}
    if isinstance(tp, type):
        if tp is Resource:
            return lambda data: Resource(
                milli_cpu=data.get("cpu", 0.0),
                memory=data.get("mem", 0.0),
                scalars=data.get("scalars"),
                max_task_num=data.get("max_task_num"),
            )
        if issubclass(tp, enum.Enum):
            return tp
        if dataclasses.is_dataclass(tp):
            # the field plan is built on first use, so that a dataclass
            # whose hints refer to itself cannot recurse here
            plan: list = []

            def dec(data, tp=tp, plan=plan):
                if not plan:
                    hints = _hints(tp)
                    plan.extend((f.name, _decoder(hints[f.name]))
                                for f in dataclasses.fields(tp))
                kwargs = {}
                for name, d in plan:
                    if name in data:
                        kwargs[name] = d(data[name])
                return tp(**kwargs)

            return dec
        if tp in (int, float, str, bool):
            return lambda data: tp(data) if data is not None else data
    return lambda data: data


def decode(tp: Any, data: Any) -> Any:
    """JSON value -> instance of type hint ``tp``."""
    return _decoder(tp)(data)


def encode_object(kind: str, obj: Any) -> Dict[str, Any]:
    return {"kind": kind, "object": encode(obj)}


def encode_fields(fields: Dict[str, Any]) -> Dict[str, Any]:
    """Patch-field map -> JSON-compatible values (a value may be a nested
    dataclass, a whole PodGroupStatus for instance)."""
    return {k: encode(v) for k, v in fields.items()}


def _resolve_hint(cls: Any, dotted: str) -> Any:
    """The type hint at a dotted attribute path ('status.phase'), through
    nested dataclass hints; None when a hop is unknown."""
    cur = cls
    for part in dotted.split("."):
        if cur is None or not dataclasses.is_dataclass(cur):
            return None
        cur = _hints(cur).get(part)
    return cur


def decode_fields(kind: str, fields: Dict[str, Any]) -> Dict[str, Any]:
    """Inverse of ``encode_fields``, directed by the kind's class hints;
    dotted paths resolve through nested hints.  Unknown kinds and fields
    pass through (``Store.patch`` checks attribute names)."""
    cls = KIND_CLASSES.get(kind)
    if cls is None or not dataclasses.is_dataclass(cls):
        return fields
    out = {}
    for k, v in fields.items():
        hint = _resolve_hint(cls, k)
        out[k] = decode(hint, v) if hint is not None else v
    return out


def decode_object(kind: str, data: Dict[str, Any]) -> Any:
    cls = KIND_CLASSES.get(kind)
    if cls is None:
        raise KeyError(unknown_kind(kind))
    return decode(cls, data)

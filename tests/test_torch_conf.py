"""The port's scheduler-conf loader against the JAX package's.

* ``conf.parse_yaml``, the port's reader of the YAML subset a scheduler
  conf uses, equals ``yaml.safe_load`` on ``examples/scheduler-conf.yaml``,
  on every conf text the JAX package's tests hand to ``load_conf``
  (``tests/test_async_apply.py``, ``test_columnar_wire.py``,
  ``test_multihost.py``, ``test_parallel.py``) and on texts that reach the
  rest of the subset (quoting, YAML 1.1 booleans, nulls, nested lists,
  comments).
* ``load_conf`` equals the JAX ``load_conf`` field by field under the
  mapping rules of ``volcano_tpu_torch/scheduler/conf.py`` (``backend: tpu``
  -> ``cuda``, an absent backend -> ``cuda``, an absent ``applyMode`` ->
  ``sync``) wherever the port accepts the text, and both loaders raise
  ``ValueError`` on the same malformed texts.  ``delta`` and every
  ``delta*`` key load field for field (``DELTA_TEXTS``).
* Each departure raises ``ValueError``: ``backend: host`` / ``native``,
  ``columnarPublish: false``, ``exactTopK: false``, and what the reader
  does not cover.
* A conf with ``enablePredicate: false`` and ``enableNodeOrder: false``
  schedules as the JAX Scheduler does, on the fast path and on the object
  path (binds, pods and PodGroup statuses; tolerance: exact).
"""

import os

import pytest
import torch
import yaml

from volcano_tpu.scheduler import conf as jconf
from volcano_tpu.scheduler.scheduler import Scheduler as JScheduler
from volcano_tpu_torch.scheduler import conf as tconf
from volcano_tpu_torch.scheduler.scheduler import Scheduler

from helpers import build_node, build_pod, build_podgroup, make_store
from test_torch_object import _outcome, port_store

torch.set_num_threads(1)

EXAMPLE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "examples", "scheduler-conf.yaml")

# the texts the JAX package's tests load (file:line of each)
JAX_TEST_TEXTS = [
    "applyMode: Async\n",                                          # test_async_apply.py:197
    "applyMode: async\n",                                          # :198
    "actions: allocate\n",                                         # :199
    "columnarPublish: false\n",                                    # test_columnar_wire.py:508
    "backend: tpu\nmeshHosts: 2\nmeshHostId: 1\n",                 # test_multihost.py:94
    "meshHosts: 0\n",                                              # :97
    "meshHosts: 2\nmeshHostId: 2\n",                               # :99
    "backend: native\nmeshHosts: 2\n",                             # :106
    "backend: tpu\nmeshHosts: 2\nactions: allocate,preempt\n",     # :109
    "backend: tpu\nsolveMode: batch\nexactTopK: true\n",           # :129 with "", :144
    "backend: tpu\nsolveMode: batch\nexactTopK: true\nmeshHosts: 2\nmeshHostId: 0\n",  # :145
    "backend: tpu\nsolveMode: batch\nexactTopK: true\nmeshHosts: 2\nmeshHostId: 1\n",  # :146
    "backend: tpu\nsolveMode: batch\nexactTopK: true\nmesh: 8\n",  # test_parallel.py:99, :113
    "backend: tpu\nsolveMode: batch\nexactTopK: true\nmesh: off\n",  # :115, :272
    "mesh: auto\n",                                                # :124
    "mesh: sideways\n",                                            # :131
    "backend: tpu\nexactTopK: true\nsolveMode: batch\n",           # :183
    "backend: tpu\nsolveMode: batch\nexactTopK: true\nmesh: 2\n",  # :256, :270
]

# the rest of the subset
SUBSET_TEXTS = [
    "---\n# a comment\nactions: 'enqueue, allocate'   # trailing\nbackend: \"cpu\"\n"
    "fastPath: \"off\"\nschedulePeriod: 0.5\nmirrorCheckpoint: /var/lib/vt/mirror.ckpt\n"
    "delta: off\napplyMode: sync\n",
    "tiers:\n  - plugins:\n      - name: gang\n        enableJobReady: false\n"
    "        enablePreemptable: off\n      - name: drf\n        enableJobOrder: No\n"
    "  - plugins:\n    - name: predicates\n      enablePredicate: false\n"
    "    - name: nodeorder\n      enableNodeOrder: FALSE\n      arguments:\n"
    "        nodeaffinity.weight: 2.5\n        podaffinity.weight: '3'\n",
    "mirrorCheckpoint: ~\nsolveMode: exact\nmesh: 4\nmeshHosts: 1\n",
    "actions: allocate, backfill\nbackend: tpu\nexactTopK: yes\ncolumnarPublish: on\n",
    "",
    "# only a comment\n",
]


# incremental scheduling's keys, each loaded field for field
DELTA_TEXTS = [
    "delta: on\n",
    "deltaAdmitQps: 100\n",
    "delta: off\ndeltaOracle: true\n",
    "backend: tpu\ndelta: \"on\"\ndeltaAdmitQps: 250.5\ndeltaBurst: 16\n"
    "deltaHighWatermark: 64\ndeltaLowWatermark: 8\ndeltaOracle: yes\n",
    "delta: sideways\n",
]


def _texts():
    with open(EXAMPLE) as f:
        return [f.read()] + JAX_TEST_TEXTS + SUBSET_TEXTS + DELTA_TEXTS


@pytest.mark.parametrize("text", _texts())
def test_reader_equals_yaml_safe_load(text):
    assert tconf.parse_yaml(text) == yaml.safe_load(text)


def _port_backend(text):
    raw = (yaml.safe_load(text) or {}).get("backend", "cuda")
    return {"tpu": "cuda"}.get(raw, raw)


def _same_fields(jc, tc, text):
    assert tc.actions == jc.actions
    assert len(tc.tiers) == len(jc.tiers)
    for jt, tt in zip(jc.tiers, tc.tiers):
        assert [p.name for p in tt.plugins] == [p.name for p in jt.plugins]
        for jp, tp in zip(jt.plugins, tt.plugins):
            assert tp.arguments == jp.arguments
            for flag in jconf._FLAG_NAMES:
                assert getattr(tp, flag) == getattr(jp, flag), flag
    assert tc.backend == _port_backend(text)
    assert tc.apply_mode == (jc.apply_mode or "sync")
    for name in ("solve_mode", "schedule_period", "fast_path", "mesh", "mesh_hosts",
                 "mesh_host_id", "mirror_checkpoint", "delta", "delta_admit_qps",
                 "delta_burst", "delta_high_watermark", "delta_low_watermark",
                 "delta_oracle"):
        assert getattr(tc, name) == getattr(jc, name), name


def _refused(text):
    """The port's departures in ``text`` (keys the JAX loader reads and the
    port refuses)."""
    data = yaml.safe_load(text) or {}
    return (data.get("backend") in ("host", "native")
            or data.get("columnarPublish") is False or data.get("exactTopK") is False)


@pytest.mark.parametrize("text", _texts())
def test_load_conf_equals_jax(text):
    """Field for field under the mapping rules; a text the JAX loader
    refuses the port refuses too."""
    try:
        jc = jconf.load_conf(text)
    except ValueError:
        with pytest.raises(ValueError):
            tconf.load_conf(text)
        return
    if _refused(text):
        with pytest.raises(ValueError):
            tconf.load_conf(text)
        return
    _same_fields(jc, tconf.load_conf(text), text)


@pytest.mark.parametrize("text,needle", [
    ("backend: host\n", "host"),
    ("backend: native\n", "native"),
    ("backend: gpu\n", "backend"),
    ("columnarPublish: false\n", "columnarPublish"),
    ("exactTopK: false\n", "exactTopK"),
    ("delta: sideways\n", "delta"),
    ("applyMode: Async\n", "applyMode"),
    ("fastPath: maybe\n", "fastPath"),
    ("fastPath: off\n", "fastPath"),  # YAML 1.1 reads a bare off as false, as JAX does
    ("meshHosts: 2\nmeshHostId: 2\n", "mesh_host_id"),
    ("actions: [allocate]\n", "subset"),
    ("a: |\n  text\n", "subset"),
    ("a: 1\n b: 2\n", "indentation"),
    ("a: 'open\n", "unterminated"),
    ("- a\n- b\n", "mapping"),
])
def test_refusals_raise(text, needle):
    with pytest.raises(ValueError, match=needle):
        tconf.load_conf(text)


def test_from_conf_yaml_builds_the_loaded_conf():
    from volcano_tpu_torch.store import Store

    with open(EXAMPLE) as f:
        text = f.read().replace("backend: tpu", "backend: cpu")
    sched = Scheduler.from_conf_yaml(Store(), text)
    assert sched.conf.backend == "cpu" and sched.device.type == "cpu"
    assert sched.conf.actions == ["enqueue", "reclaim", "allocate", "backfill", "preempt"]
    assert sched.conf.tiers[1].plugins[3].arguments["nodeaffinity.weight"] == "1"


FLAGS_OFF = """
actions: "enqueue, allocate, backfill"
backend: tpu
fastPath: "{fast}"
tiers:
- plugins:
  - name: priority
  - name: gang
- plugins:
  - name: drf
  - name: predicates
    enablePredicate: false
  - name: proportion
  - name: nodeorder
    enableNodeOrder: false
    arguments:
      nodeaffinity.weight: 3
"""


def _labelled_cluster():
    """Zoned nodes of two sizes; gangs pinned to a zone, and best-effort
    pods with a node selector (backfill asks the session's predicates)."""
    nodes = [build_node(f"n{i}", cpu=str(2 + 2 * (i % 2)), memory="8Gi",
                        labels={"zone": f"z{i % 3}"}) for i in range(6)]
    pgs, pods = [], []
    for j in range(4):
        pgs.append(build_podgroup(f"pg{j}", min_member=2))
        for k in range(2):
            pod = build_pod(f"p{j}-{k}", group=f"pg{j}", cpu="1")
            pod.spec.node_selector = {"zone": f"z{j % 3}"}
            pods.append(pod)
    for k in range(3):
        pod = build_pod(f"be{k}", group="pg0", cpu="0", memory="0")
        pod.spec.node_selector = {"zone": "z2"}
        pods.append(pod)
    return make_store(nodes=nodes, podgroups=pgs, pods=pods)


@pytest.mark.parametrize("fast", ["auto", "off"])
def test_flags_off_schedule_as_jax(fast):
    text = FLAGS_OFF.format(fast=fast)
    jc = jconf.load_conf(text)
    tc = tconf.load_conf(text)
    tc.backend = "cpu"
    preds = tc.tiers[1].plugins[1]
    assert not preds.enabled_predicate and not tc.tiers[1].plugins[3].enabled_node_order
    js = _labelled_cluster()
    ts = port_store(js)
    jsched, tsched = JScheduler(js, conf=jc), Scheduler(ts, conf=tc)
    for cycle in range(2):
        jsched.run_once()
        tsched.run_once()
        jo, to = _outcome(js, jsched), _outcome(ts, tsched)
        for key in ("binds", "pods", "groups"):
            assert to[key] == jo[key], f"cycle {cycle}: {key}"
        assert tsched.last_path == ("fast" if fast == "auto" else "object")
    assert len(tsched.cache.bind_log) == 11

"""``chip_smoke.py``'s configurations held to ``bench.py``'s, field for field.

The chip phases build their stores and load specs with the port's objects;
these cases hold them to what the JAX package's ``bench.py`` builds and
passes, so that a phase keeps the published widths:

* config 8 (phase 30): ``build_open_loop_store`` against
  ``bench._build_open_loop_store`` (every node's name and allocatable, the
  queue), and ``cfg8_specs`` with ``CFG8`` against the LoadSpecs, settle,
  apply mode, base runs and saturation search ``bench.config8_open_loop``
  runs, read by running it with its Scheduler, open loop and search
  replaced by recorders (nothing is scheduled);
* cfg9b (phase 31): ``CFG9B`` against ``bench.N_NODES`` / ``N_TASKS`` /
  ``CFG9_NAMESPACES`` and the shard count ``config9_shard`` defaults to.
"""

import dataclasses

import bench
import chip_smoke
from volcano_tpu import loadgen as jloadgen
from volcano_tpu.scheduler import scheduler as jscheduler


class _Report:
    p50_ms = p99_ms = p999_ms = 1.0

    def as_dict(self):
        return {}


def _record_config8(monkeypatch):
    """Run bench.config8_open_loop with recorders in place of the scheduler,
    the open loop and the saturation search; what it passed to them."""
    seen = {"loops": [], "confs": [], "search": None, "printed": []}

    class FakeScheduler:
        prewarm_background = None

        def __init__(self, store, conf):
            seen["confs"].append(conf)

        def prewarm(self):
            return 0.0

        def run_once(self):
            pass

    def run_open_loop(store, spec, pump, settle_s=30.0, **kw):
        seen["loops"].append((store, spec, settle_s, kw))
        return _Report()

    def saturation_search(run_at, base_qps, band_p99_ms, max_doublings=4):
        seen["search"] = dict(base_qps=base_qps, band_p99_ms=band_p99_ms,
                              max_doublings=max_doublings, n_before=len(seen["loops"]))
        run_at(base_qps)

        class Result:
            def as_dict(self):
                return {}

        return Result()

    monkeypatch.setattr(jscheduler, "Scheduler", FakeScheduler)
    monkeypatch.setattr(jloadgen, "run_open_loop", run_open_loop)
    monkeypatch.setattr(jloadgen, "saturation_search", saturation_search)
    monkeypatch.setattr(bench, "_print_json", seen["printed"].append)
    bench.config8_open_loop()
    return seen


def _fields(spec):
    return dataclasses.asdict(spec)


def test_config8_store_equals_bench():
    jstore = bench._build_open_loop_store()
    tstore = chip_smoke.build_open_loop_store()

    def nodes(store):
        return [(n.meta.name, n.allocatable.milli_cpu, n.allocatable.memory,
                 n.allocatable.max_task_num) for n in store.list("Node")]

    assert nodes(tstore) == nodes(jstore)
    assert len(nodes(tstore)) == chip_smoke.CFG8["nodes"] == 200
    assert ([(q.meta.name, q.weight) for q in tstore.list("Queue")]
            == [(q.meta.name, q.weight) for q in jstore.list("Queue")])


def test_config8_specs_and_search_equal_bench(monkeypatch):
    seen = _record_config8(monkeypatch)
    cfg = chip_smoke.CFG8
    loops = seen["loops"]
    n_base = seen["search"]["n_before"] // 2
    assert n_base == cfg["base_runs"] == 2
    # every run: the warm burst, then the measured spec
    warm, base = chip_smoke.cfg8_specs(cfg["qps"], cfg["duration_s"])
    for i in range(n_base):
        (_, jwarm, wsettle, _), (_, jspec, settle, kw) = loops[2 * i], loops[2 * i + 1]
        assert _fields(warm) == _fields(jwarm)
        assert _fields(base) == _fields(jspec)
        assert settle == wsettle == cfg["settle_s"] and kw == {}
    search = seen["search"]
    assert search["base_qps"] == cfg["qps"] * 2
    assert search["band_p99_ms"] == cfg["band_p99_ms"]
    assert search["max_doublings"] == cfg["max_doublings"]
    # a saturation step's run: the same warm burst, a shorter window
    _, sat = chip_smoke.cfg8_specs(search["base_qps"], max(cfg["duration_s"] / 2.0, 3.0))
    assert _fields(sat) == _fields(loops[-1][1])
    assert _fields(warm) == _fields(loops[-2][1])
    assert {c.apply_mode for c in seen["confs"]} == {"async"}
    # the stores the runs were given are bench's open-loop store
    assert len(loops[0][0].list("Node")) == cfg["nodes"]


def test_cfg9b_scale_equals_bench():
    cfg = chip_smoke.CFG9B
    assert (cfg["nodes"], cfg["tasks"]) == (bench.N_NODES, bench.N_TASKS)
    assert cfg["namespaces"] == bench.CFG9_NAMESPACES
    assert cfg["shards"] == 4  # config9_shard's VOLCANO_TPU_CFG9_SHARDS default
    assert cfg["tasks_per_job"] == 20

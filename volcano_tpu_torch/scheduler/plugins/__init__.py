"""Plugin registry bootstrap: importing this package registers the seven
built-in plugins (the port's copy of
``volcano_tpu/scheduler/plugins/__init__.py``)."""

from volcano_tpu_torch.scheduler.framework import register_plugin_builder
from volcano_tpu_torch.scheduler.plugins import (
    conformance,
    drf,
    gang,
    nodeorder,
    predicates,
    priority,
    proportion,
)

register_plugin_builder("gang", gang.GangPlugin)
register_plugin_builder("priority", priority.PriorityPlugin)
register_plugin_builder("drf", drf.DRFPlugin)
register_plugin_builder("proportion", proportion.ProportionPlugin)
register_plugin_builder("predicates", predicates.PredicatesPlugin)
register_plugin_builder("nodeorder", nodeorder.NodeOrderPlugin)
register_plugin_builder("conformance", conformance.ConformancePlugin)

"""The system under test: ``metrics_tpu_torch``'s ``MetricCollection`` as the
configuration and the traffic describe it.

A configuration lists its members (``members``: a name, the port's metric
class, its arguments, and ``kernels``: the work its update hands to each of
the port's kernels, ``benchmark/kernels/<kernel>.py``); a traffic mix may add
members (``extra_members``) and wrap every member in one of the port's
wrapper classes (``wrap``: its class and arguments, the member passed
first). A string ``"${key}"`` or ``"${key.sub}"`` takes that value of the
configuration, or of the traffic where the configuration has no such key.
Nothing here names a cell, a metric class or a wrapper.
"""
from typing import Any, Dict, Optional

# the top-level modules that no process of the benchmark may hold: JAX and
# the JAX package (whose name the port's begins with; compared whole)
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "metrics_tpu")


def _filler(config: Dict[str, Any], traffic: Dict[str, Any]) -> Any:
    def lookup(path: str) -> Any:
        for source in (config, traffic):
            value: Any = source
            for key in path.split("."):
                if not isinstance(value, dict) or key not in value:
                    break
                value = value[key]
            else:
                return value
        raise KeyError(f"${{{path}}} is in neither the configuration nor the traffic")

    def fill(value: Any) -> Any:
        if isinstance(value, str) and value.startswith("${") and value.endswith("}"):
            return lookup(value[2:-1])
        if isinstance(value, dict):
            return {k: fill(v) for k, v in value.items()}
        return value

    return fill


def member_specs(config: Dict[str, Any], traffic: Dict[str, Any]) -> Dict[str, Dict[str, Any]]:
    """``{member: {"metric", "args", "kernels", "wrap"}}`` with the
    placeholders filled in; ``wrap`` is ``{"metric", "args"}`` or None."""
    fill = _filler(config, traffic)
    wrap: Optional[Dict[str, Any]] = traffic.get("wrap")
    wrap = None if wrap is None else {"metric": wrap["metric"], "args": fill(wrap.get("args", {}))}
    specs = {**config["members"], **traffic.get("extra_members", {})}
    return {name: {"metric": s["metric"], "args": fill(s.get("args", {})), "kernels": fill(s.get("kernels", {})), "wrap": wrap}
            for name, s in specs.items()}


def build_collection(members: Dict[str, Dict[str, Any]], device: Any) -> Any:
    import metrics_tpu_torch as mtt

    built = {}
    for name, spec in members.items():
        metric = getattr(mtt, spec["metric"])(**spec["args"], device=device)
        if spec["wrap"] is not None:
            metric = getattr(mtt, spec["wrap"]["metric"])(metric, **spec["wrap"]["args"])
        built[name] = metric
    return mtt.MetricCollection(built)


def base_members(collection: Any) -> Dict[str, Any]:
    """The collection's metrics, each once (compute groups included)."""
    return dict(collection.items(keep_base=True, copy_state=False))


def graph_replays(collection: Any) -> int:
    """Replays summed over the members' tables of captured graphs
    (``UpdateGraphs``; a table's counters outlive ``reset``)."""
    tables = (m.__dict__.get("_update_graphs") for m in base_members(collection).values())
    return sum(int(t.replays) for t in tables if t is not None)


def member_updates(collection: Any) -> int:
    """Updates that the members ran since their last ``reset``. Once the
    collection has formed its compute groups only each group's first member
    runs an update (the others take its count), so only those count."""
    if getattr(collection, "_groups_checked", False):
        return sum(int(collection._modules[group[0]].update_count) for group in collection._groups.values())
    return sum(int(m.update_count) for m in base_members(collection).values())


def forbidden_loaded(modules: Any) -> list:
    """The names in ``modules`` (``sys.modules``) whose top-level name is one
    of :data:`FORBIDDEN_MODULES`, compared whole."""
    return sorted(name for name in modules if name.split(".")[0] in FORBIDDEN_MODULES)

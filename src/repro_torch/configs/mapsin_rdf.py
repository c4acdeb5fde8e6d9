"""The paper's own workload config: RDF triple store + MAPSIN join engine.

A copy of the JAX package's ``configs/mapsin_rdf.py``. Not an LM
architecture: it parameterizes the core/ join engine (store shards, probe
and result capacities) for the examples. ``sort_impl`` and ``lookup_impl``
take the port's ``ExecConfig.impl`` values: ``"torch"`` (the JAX package's
``"jnp"``, the plain versions) or ``"kernel"`` (its
``"pallas_interpret"``: the hand-written CUDA kernels on a CUDA tensor).
"""
import dataclasses


@dataclasses.dataclass(frozen=True)
class MapsinConfig:
    name: str = "mapsin-rdf"
    num_shards: int = 8           # logical store shards (HBase regions)
    probe_capacity: int = 4       # matches fetched per probe key (per pattern)
    result_capacity: int = 1 << 16  # solution-multiset capacity per shard
    sort_impl: str = "torch"      # torch | kernel
    lookup_impl: str = "torch"


def config() -> MapsinConfig:
    return MapsinConfig()

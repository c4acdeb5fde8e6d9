from repro_torch.sharding.rules import (  # noqa: F401
    NamedSharding, PartitionSpec, Rules, ShardedTensor, choose_kv_mode,
    make_rules, single_device_mesh,
)

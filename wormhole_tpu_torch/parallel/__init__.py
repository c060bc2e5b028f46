from wormhole_tpu_torch.parallel.kvstore import KVStore, TableSpec  # noqa: F401

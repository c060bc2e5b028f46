"""CLI apps — the reference's `bin/*.dmlc` binaries as python -m entry
points:

  python -m wormhole_tpu_torch.apps.linear   conf [key=val ...]   linear.dmlc
  python -m wormhole_tpu_torch.apps.difacto  conf [key=val ...]   difacto.dmlc

Each reads a `key = value` conf file plus CLI overrides (arg_parser.h
semantics) and runs single-process on one device (`device=cuda` by
default).
"""

"""CLI apps — the reference's `bin/*.dmlc` binaries as python -m entry
points:

  python -m wormhole_tpu_torch.apps.linear   conf [key=val ...]   linear.dmlc
  python -m wormhole_tpu_torch.apps.difacto  conf [key=val ...]   difacto.dmlc
  python -m wormhole_tpu_torch.apps.gbdt     conf [key=val ...]   xgboost.dmlc
  python -m wormhole_tpu_torch.apps.kmeans   data=... [key=val ...]   kmeans.dmlc
  python -m wormhole_tpu_torch.apps.lbfgs_linear data=... [key=val ...]
                                                          lbfgs linear.dmlc
  python -m wormhole_tpu_torch.apps.lbfgs_fm data=... [key=val ...]   fm.dmlc
  python -m wormhole_tpu_torch.apps.convert data_in=... data_out=... [key=val ...]
                                                          convert.dmlc

Every app reads its data through `data_format=` (convert:
`format_in=`): libsvm, criteo, criteo_test, adfea or crb.

Each reads a `key = value` conf file plus CLI overrides (arg_parser.h
semantics) and runs single-process on one device (`device=cuda` by
default). linear and gbdt also run under `python -m torch.distributed.run
--nproc-per-node N -m ...`, one rank a device, on a mesh of the ranks;
linear and difacto under the PS launcher (`python -m
wormhole_tpu_torch.launcher.dmlc_tpu -n N -s S -- python -m ...`), as
its scheduler, server, serve and worker roles (apps/_runner.py).
"""

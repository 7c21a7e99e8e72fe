"""The operator's drivers, each the port's copy of the JAX package's script
of the same name under `scripts/`, run as
`python -m celestia_app_tpu_torch.scripts.<name>`:

  chaos_soak     the fault drills ("faults cost latency, never correctness")
  das_loadgen    the read side's load generator (closed loop, swarm, QoS,
                 attestation, --url / --urls / --serve)
  block_anatomy  the height-anatomy timeline of a streamed run
  devnet_smoke   a multi-process devnet: a validator killed, a Commit
                 verified by a light client
  trace_lint     the metric-name lint over this package

Each takes `--device` (default CUDA, which raises without a card; `--device
cpu` runs the plain PyTorch versions of the kernels).  Importing a module
changes nothing: no environment variable and no `sys.path` entry is
written at import.  `common` holds the helpers the drivers share.
"""

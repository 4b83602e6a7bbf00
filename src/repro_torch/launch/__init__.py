"""Command-line entry points of the port: ``python -m repro_torch.launch.train``
(``graph``: federated FedGAT training; ``lm``: the language-model zoo),
``python -m repro_torch.launch.serve`` (``--mode lm``, the default, and
``--mode graph``), ``python -m repro_torch.launch.multiprocess`` (the
shard_map backend over a multi-process group) and ``python -m
repro_torch.launch.dryrun`` (the analytic dry-run); ``launch.steps`` holds
the LM train, prefill and decode steps and ``build_sharded_step``, over the
mesh layer (``mesh``, ``pspec``, ``sharding``, ``specs``)."""

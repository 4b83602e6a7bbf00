"""Command-line entry points of the port: ``python -m repro_torch.launch.serve``
(federated graph serving) and ``python -m repro_torch.launch.multiprocess``
(the shard_map backend over a multi-process group)."""

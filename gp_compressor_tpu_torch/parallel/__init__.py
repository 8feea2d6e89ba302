"""Multi-device execution over torch.distributed: the (data x chain) mesh
(`mesh`), joining the process group (`distributed`) and the per-rank
layout report of the sharded pipelines (`shard_report`)."""

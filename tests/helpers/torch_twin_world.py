"""A fake two-rank world for the port's ``fused_sync``: a communicator
(``Metric(dist_sync_fn=...)``) whose other rank holds exactly what this
rank holds. A sum doubles, a max or min stays, a gather gives every tensor
twice. It records each collective it is sent."""
import torch.distributed as dist


class TwinWorld:
    def __init__(self):
        self.calls = []

    def get_world_size(self, group=None):
        return 2

    def get_rank(self, group=None):
        return 0

    def all_reduce(self, tensor, op=dist.ReduceOp.SUM, group=None):
        self.calls.append(("all_reduce", tensor.clone()))
        if op == dist.ReduceOp.SUM:
            tensor.mul_(2)

    def all_gather(self, parts, tensor, group=None):
        self.calls.append(("all_gather", tensor.clone()))
        for part in parts:
            part.copy_(tensor)

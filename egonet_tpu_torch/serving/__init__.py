from egonet_tpu_torch.serving.server import (MicroBatcher, OverloadedError,
                                             PoseServer)

__all__ = ["MicroBatcher", "OverloadedError", "PoseServer"]

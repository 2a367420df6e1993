from parallel_ddp_tpu_torch.runtime.pubsub import PubSub, Channels
from parallel_ddp_tpu_torch.runtime import messages

__all__ = ["PubSub", "Channels", "messages"]

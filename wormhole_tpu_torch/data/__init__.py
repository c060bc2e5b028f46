from wormhole_tpu_torch.data.rowblock import RowBlock, DeviceBatch  # noqa: F401
from wormhole_tpu_torch.data.minibatch import MinibatchIter  # noqa: F401

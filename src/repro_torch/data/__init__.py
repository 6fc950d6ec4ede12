from repro_torch.data.synthetic import make_cifar_like, make_lm_data  # noqa: F401
from repro_torch.data.partition import partition_iid, partition_noniid_shards  # noqa: F401
from repro_torch.data.pipeline import (ClientSampler, DeviceClientStore,  # noqa: F401
                                       draw_indices)

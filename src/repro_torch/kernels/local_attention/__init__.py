from repro_torch.kernels.local_attention.ops import flash_attention
from repro_torch.kernels.local_attention.ref import attention_ref

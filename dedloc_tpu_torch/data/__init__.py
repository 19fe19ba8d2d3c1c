from dedloc_tpu_torch.data.mlm import (
    SpecialTokens,
    create_instances_from_document,
    mask_tokens,
    pad_and_batch,
)
from dedloc_tpu_torch.data.streaming import (
    ShuffleBuffer,
    interleave_weighted,
    repeat_forever,
)

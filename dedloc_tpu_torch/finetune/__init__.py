"""Downstream fine-tuning of collaboratively pretrained checkpoints, in
PyTorch: NER (wikiann/bn, ``ner.py``) and news categories (indic_glue
sna.bn, ``ncc.py``) over the port's classification heads. The JAX
package's ``linear_probe`` comes with the SwAV slice."""
from dedloc_tpu_torch.finetune.driver import (  # noqa: F401
    EarlyStopping,
    FinetuneArguments,
    evaluate,
    finetune,
)
from dedloc_tpu_torch.finetune.metrics import (  # noqa: F401
    accuracy_score,
    extract_entities,
    span_f1,
)

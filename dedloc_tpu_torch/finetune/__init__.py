"""Downstream fine-tuning of collaboratively pretrained checkpoints, in
PyTorch: NER (wikiann/bn, ``ner.py``) and news categories (indic_glue
sna.bn, ``ncc.py``) over the port's classification heads, and the linear
probe of a SwAV trunk (``linear_probe.py``)."""
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
from dedloc_tpu_torch.finetune.linear_probe import (  # noqa: F401
    LinearProbeArguments,
    TopKMeter,
    extract_features,
    run_linear_probe,
)

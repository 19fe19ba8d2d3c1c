"""The fine-tune loop with early stopping, in PyTorch.

Port of ``dedloc_tpu/finetune/driver.py`` (the reference's HF ``Trainer`` +
``EarlyStoppingCallback`` skeleton, train_ner.py:107-125:
load_best_model_at_end, metric_for_best_model="loss", per-epoch eval,
patience 1 / threshold 0.0): one AdamW step per static-shape batch,
per-epoch evaluation, best-params restore. The data side
(``load_split_examples``, ``FinetuneArguments``, ``EarlyStopping``,
``_batches``) is the JAX package's, so the batch order is the same for a
seed. ``AdamW`` is ``optax.adamw(schedule, weight_decay)``: b1 0.9, b2
0.999, eps 1e-8, the bias corrections as divisions, decoupled decay on
every leaf, the schedule at the 0-based update count.
"""
from __future__ import annotations

import dataclasses
import logging
from typing import Callable, Dict, Mapping, NamedTuple, Optional, Tuple

import numpy as np
import torch

from dedloc_tpu_torch.models.albert import classification_loss, init_weights
from dedloc_tpu_torch.optim.lamb import bias_corrections, debiased
from dedloc_tpu_torch.optim.schedules import linear_warmup_linear_decay
from dedloc_tpu_torch.utils.device import DeviceLike, resolve_device

logger = logging.getLogger(__name__)


def load_split_examples(dataset_name: str, config_name: str):
    """train/validation examples through the same ``datasets.load_dataset``
    entry point the reference fine-tunes use (train_ner.py / train_ncc.py).
    ``dataset_name`` may be a hub id (networked) or a local directory holding
    ``train.jsonl`` / ``validation.jsonl`` with the dataset's columns, which
    runs the identical Arrow ingestion path offline. Split files are selected
    explicitly (``data_files``) so unrelated files living in the same dir —
    a tokenizer.json, checkpoints — don't get swept into the dataset by
    module inference."""
    import os

    from datasets import load_dataset  # deferred: heavy + networked

    if os.path.isdir(dataset_name):
        if config_name:
            logger.info(
                "dataset config %r ignored for local data-files dir %s",
                config_name,
                dataset_name,
            )

        def split_file(*stems):
            # exact names only (train*.json* would sweep a train_log.jsonl
            # run log or a .json.bak backup into the split); first matching
            # stem wins so validation.jsonl shadows a stale val.jsonl
            for stem in stems:
                for ext in (".jsonl", ".json"):
                    path = os.path.join(dataset_name, stem + ext)
                    if os.path.exists(path):
                        return path
            raise FileNotFoundError(
                f"{dataset_name} has no {stems[0]} data file (expected one "
                f"of: {', '.join(s + e for s in stems for e in ('.jsonl', '.json'))})"
            )

        data_files = {
            "train": split_file("train"),
            "validation": split_file("validation", "val"),
        }
        ds = load_dataset("json", data_files=data_files)
    else:
        ds = load_dataset(dataset_name, config_name)
    return list(ds["train"]), list(ds["validation"])


@dataclasses.dataclass
class FinetuneArguments:
    """Knobs mirroring the fine-tune TrainingArguments the reference sets."""

    learning_rate: float = 5e-5
    weight_decay: float = 0.0
    num_train_epochs: int = 3
    per_device_batch_size: int = 32
    warmup_ratio: float = 0.1
    seed: int = 0
    # EarlyStoppingCallback knobs (train_ner.py:97-104 defaults)
    early_stopping_patience: int = 1
    early_stopping_threshold: float = 0.0
    metric_for_best_model: str = "loss"
    greater_is_better: bool = False
    classifier_dropout: float = 0.1


class EarlyStopping:
    """load_best_model_at_end + EarlyStoppingCallback in one object."""

    def __init__(
        self,
        patience: int = 1,
        threshold: float = 0.0,
        greater_is_better: bool = False,
    ):
        self.patience = patience
        self.threshold = threshold
        self.greater_is_better = greater_is_better
        self.best: Optional[float] = None
        self.bad_evals = 0

    def improved(self, value: float) -> bool:
        if self.best is None:
            return True
        if self.greater_is_better:
            return value > self.best + self.threshold
        return value < self.best - self.threshold

    def record(self, value: float) -> bool:
        """Returns True when training should STOP."""
        if self.improved(value):
            self.best = value
            self.bad_evals = 0
            return False
        self.bad_evals += 1
        return self.bad_evals >= self.patience


def _batches(data: Dict[str, np.ndarray], batch_size: int, rng: np.random.Generator):
    """Shuffled fixed-shape batches; the final ragged batch is wrapped around
    (static shapes keep one compiled program — the TPU constraint the
    reference's pad_to_max_length note points at)."""
    n = len(next(iter(data.values())))
    order = rng.permutation(n)
    if n % batch_size:
        # np.resize tiles the permutation, so this holds even when the pad
        # needed exceeds n (e.g. n=10, batch_size=32)
        order = np.resize(order, n + batch_size - n % batch_size)
    for i in range(0, len(order), batch_size):
        idx = order[i : i + batch_size]
        yield {k: v[idx] for k, v in data.items()}


class AdamWState(NamedTuple):
    count: int  # updates so far (optax's ScaleByAdamState.count)
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]


class AdamW:
    """``optax.adamw(schedule, weight_decay=weight_decay)``, in place:
    ``u = m_hat / (sqrt(v_hat) + eps) + weight_decay * p`` and ``p -= lr * u``
    with ``lr = schedule(count)`` before the count advances."""

    def __init__(self, schedule: Callable[[int], float], weight_decay: float,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.schedule = schedule
        self.weight_decay = weight_decay
        self.b1, self.b2, self.eps = b1, b2, eps

    def init(self, params: Mapping[str, torch.Tensor]) -> AdamWState:
        zeros = lambda: {n: torch.zeros_like(p) for n, p in params.items()}
        return AdamWState(count=0, mu=zeros(), nu=zeros())

    @torch.no_grad()
    def step(self, params: Mapping[str, torch.Tensor],
             grads: Mapping[str, Optional[torch.Tensor]],
             state: AdamWState) -> AdamWState:
        """Updates ``params`` in place; a None gradient (a leaf the loss does
        not reach, as the pooler under the token head) counts as zeros."""
        b1, b2 = self.b1, self.b2
        count = state.count + 1
        bc1, bc2 = bias_corrections(b1, b2, count)
        step_size = -float(np.float32(self.schedule(state.count)))
        mu, nu = {}, {}
        for n, p in params.items():
            g = grads[n] if grads[n] is not None else torch.zeros_like(p)
            mu[n] = (1 - b1) * g + b1 * state.mu[n]
            nu[n] = (1 - b2) * (g * g) + b2 * state.nu[n]
            mu_hat, nu_hat = debiased(mu[n], nu[n], bc1, bc2)
            u = mu_hat / (torch.sqrt(nu_hat) + self.eps)
            if self.weight_decay:
                u = u + self.weight_decay * p
            p.add_(step_size * u)
        return AdamWState(count=count, mu=mu, nu=nu)


def make_eval_step(model: torch.nn.Module) -> Callable:
    """``eval_step(batch) -> (predictions, summed masked loss, labels
    counted)`` on device tensors, the model applied deterministically."""

    @torch.no_grad()
    def eval_step(batch):
        logits = model(batch["input_ids"], batch["attention_mask"],
                       batch.get("token_type_ids"), deterministic=True)
        loss, metrics = classification_loss(logits, batch["labels"])
        return (logits.argmax(-1), loss * metrics["n_labels"],
                metrics["n_labels"])

    return eval_step


def _to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def evaluate(
    model: torch.nn.Module,
    data: Dict[str, np.ndarray],
    batch_size: int,
    eval_step: Optional[Callable] = None,
) -> Tuple[float, np.ndarray]:
    """Returns (mean masked loss, predictions over the full set,
    unshuffled), on the model's device. Each batch has the static shape: the
    last is padded with rows labelled -100, which add no loss."""
    if eval_step is None:
        eval_step = make_eval_step(model)
    device = next(model.parameters()).device
    n = len(data["input_ids"])
    preds = []
    total_loss = 0.0
    total_labels = 0.0
    for i in range(0, n, batch_size):
        idx = np.arange(i, min(i + batch_size, n))
        real = len(idx)
        if real < batch_size:  # pad to static shape, then slice off
            idx = np.concatenate([idx, np.zeros(batch_size - real, np.int64)])
        batch = {k: v[idx].copy() for k, v in data.items()}
        batch["labels"][real:] = -100  # padding rows contribute no loss
        p, loss_sum, n_lab = eval_step(_to_device(batch, device))
        preds.append(p.cpu().numpy()[:real])
        total_loss += float(loss_sum)
        total_labels += float(n_lab)
    return total_loss / max(1.0, total_labels), np.concatenate(preds, axis=0)


def warm_start(model: torch.nn.Module,
               init_params: Optional[Mapping[str, torch.Tensor]]) -> None:
    """Copy the ``albert.*`` backbone of ``init_params`` (the port's
    parameter names, as ``models/convert.py`` gives them) into ``model``;
    every backbone leaf must be there with the model config's shape (a
    position table smaller than --max_seq_length would otherwise index out
    of range). Heads the checkpoint lacks keep their fresh init."""
    backbone = {k: v for k, v in (init_params or {}).items()
                if k.startswith("albert.")}
    if not backbone:
        return
    fresh = {k: tuple(v.shape) for k, v in model.state_dict().items()
             if k.startswith("albert.")}
    loaded = {k: tuple(v.shape) for k, v in backbone.items()}
    if fresh != loaded:
        raise ValueError(
            "checkpoint backbone does not match the model config "
            "(e.g. --max_seq_length beyond the pretrained position table, "
            "or a different --model_size than the checkpoint was trained "
            f"with): expected {fresh}, got {loaded}"
        )
    with torch.no_grad():
        for name, p in model.state_dict().items():
            if name in backbone:
                p.copy_(backbone[name])


def finetune(
    model: torch.nn.Module,
    init_params: Optional[Mapping[str, torch.Tensor]],
    train_data: Dict[str, np.ndarray],
    eval_data: Dict[str, np.ndarray],
    args: FinetuneArguments,
    compute_metrics: Optional[Callable[[np.ndarray], Dict[str, float]]] = None,
    device: DeviceLike = None,
):
    """Fine-tune ``model`` (a classification head of ``models/albert.py``)
    on ``device`` (the card unless the caller names another) and return
    (best_params, history); the model ends holding ``best_params``.

    The weights are drawn from ``args.seed``; ``init_params`` (the port's
    parameter names) may carry a pretrained ``albert.*`` backbone, which
    replaces the fresh one. ``compute_metrics(predictions)`` turns eval
    predictions into a metric dict (train_ncc.py:199-205)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(args.seed)
    n = len(train_data["input_ids"])
    steps_per_epoch = max(1, (n + args.per_device_batch_size - 1) // (
        args.per_device_batch_size
    ))
    total_steps = steps_per_epoch * args.num_train_epochs
    schedule = linear_warmup_linear_decay(
        args.learning_rate, int(args.warmup_ratio * total_steps), total_steps
    )
    tx = AdamW(schedule, weight_decay=args.weight_decay)

    init_weights(model, torch.Generator().manual_seed(args.seed))
    warm_start(model, init_params)
    model.to(dev)
    params = dict(model.named_parameters())
    opt_state = tx.init(params)
    eval_step = make_eval_step(model)
    snapshot = lambda: {k: v.detach().clone() for k, v in params.items()}

    stopper = EarlyStopping(
        args.early_stopping_patience,
        args.early_stopping_threshold,
        args.greater_is_better,
    )
    best_params = snapshot()
    # the dropout key (the JAX package's dropout_rng, PRNGKey(seed + 1))
    generator = torch.Generator().manual_seed(args.seed + 1)
    history = []
    for epoch in range(args.num_train_epochs):
        train_loss = 0.0
        steps = 0
        for batch in _batches(train_data, args.per_device_batch_size, rng):
            batch = _to_device(batch, dev)
            logits = model(batch["input_ids"], batch["attention_mask"],
                           batch.get("token_type_ids"), deterministic=False,
                           generator=generator)
            loss, _metrics = classification_loss(logits, batch["labels"])
            grads = torch.autograd.grad(loss, list(params.values()),
                                        allow_unused=True)
            opt_state = tx.step(params, dict(zip(params, grads)), opt_state)
            train_loss += float(loss.detach())
            steps += 1
        eval_loss, preds = evaluate(
            model, eval_data, args.per_device_batch_size, eval_step=eval_step,
        )
        record = {
            "epoch": epoch,
            "train_loss": train_loss / max(1, steps),
            "eval_loss": eval_loss,
        }
        if compute_metrics is not None:
            record.update(compute_metrics(preds))
        history.append(record)
        logger.info("finetune epoch %d: %s", epoch, record)

        key = f"eval_{args.metric_for_best_model}"
        if key in record:
            value = record[key]
        elif args.metric_for_best_model in record:
            value = record[args.metric_for_best_model]
        else:
            # silently substituting eval_loss would invert the optimization
            # direction when greater_is_better=True — fail loudly instead
            raise ValueError(
                f"metric_for_best_model={args.metric_for_best_model!r} not found "
                f"in eval record; available: {sorted(record)}"
            )
        if stopper.improved(value):
            best_params = snapshot()
        if stopper.record(value):
            logger.info("early stopping at epoch %d (best=%s)", epoch, stopper.best)
            break
    # load_best_model_at_end
    with torch.no_grad():
        for k, p in params.items():
            p.copy_(best_params[k])
    return best_params, history

"""The port's fine-tuning against the JAX package's: the classification heads
and their loss, AdamW against ``optax.adamw``, NER and NCC runs epoch by
epoch at dropout 0 from the same initial weights, dropout's statistics,
warm starts from either package's pretraining checkpoint, and the CLIs
through a local JSON dataset directory."""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dedloc_tpu.finetune import ncc as jax_ncc
from dedloc_tpu.finetune import ner as jax_ner
from dedloc_tpu.finetune.driver import FinetuneArguments
from dedloc_tpu.models.albert import AlbertConfig as JaxConfig
from dedloc_tpu.models.albert import (
    AlbertForSequenceClassification as JaxSeqModel,
)
from dedloc_tpu.models.albert import AlbertForTokenClassification as JaxTokModel
from dedloc_tpu.models.albert import AlbertForPreTraining as JaxPreTraining
from dedloc_tpu.models.albert import classification_loss as jax_loss
from dedloc_tpu.optim.schedules import linear_warmup_linear_decay as jax_linear
from dedloc_tpu_torch.finetune import driver, ncc, ner
from dedloc_tpu_torch.finetune.driver import AdamW, finetune, warm_start
from dedloc_tpu_torch.models import convert
from dedloc_tpu_torch.models.albert import (
    AlbertConfig,
    AlbertForPreTraining,
    AlbertForSequenceClassification,
    AlbertForTokenClassification,
    classification_loss,
    dropout,
    init_weights,
)
from dedloc_tpu_torch.optim.schedules import linear_warmup_linear_decay
from dedloc_tpu_torch.utils.checkpoint import save_checkpoint

# one forward, the same weights: tests/test_torch_albert.py's fp32 tolerances
LOGITS_TOL = dict(atol=1e-5, rtol=1e-5)
LOSS_TOL = 1e-5
# a few AdamW steps from the same weights: the losses stay within one
# forward's tolerance, the params within tests/test_torch_train_step.py's
EPOCH_LOSS_TOL = 1e-5
PARAM_TOL = dict(atol=2e-5, rtol=1e-4)
SEQ = 32


def _named(tree):
    return {jax.tree_util.keystr(p): np.asarray(x)
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _inputs(rng, b=3, s=SEQ, vocab=128):
    ids = rng.integers(5, vocab, (b, s)).astype(np.int32)
    mask = np.ones((b, s), np.int32)
    mask[1, 20:] = 0
    types = np.zeros((b, s), np.int32)
    types[:, 16:] = 1
    return ids, mask, types


@pytest.mark.parametrize("head", ["token", "sequence"])
def test_heads_and_loss_match_jax_in_eval_mode(head):
    rng = np.random.default_rng(0)
    ids, mask, types = _inputs(rng)
    jcls, pcls = ((JaxTokModel, AlbertForTokenClassification) if head == "token"
                  else (JaxSeqModel, AlbertForSequenceClassification))
    jmodel = jcls(JaxConfig.tiny(vocab_size=128, max_position_embeddings=SEQ,
                                 dtype=jnp.float32), num_labels=7)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(1), jnp.asarray(ids))["params"]
    jlogits = jax.jit(jmodel.apply)({"params": params}, ids, mask, types)
    labels = rng.integers(0, 7, jlogits.shape[:-1]).astype(np.int32)
    if head == "token":
        labels[:, 0] = -100
        labels[1, 20:] = -100
    jl, jm = jax_loss(jlogits, jnp.asarray(labels))

    model = pcls(AlbertConfig.tiny(vocab_size=128, max_position_embeddings=SEQ,
                                   dtype=torch.float32), num_labels=7)
    model.load_state_dict(convert.params_from_jax(_named(params)))
    logits = model(*(torch.from_numpy(a) for a in (ids, mask, types)))
    assert logits.dtype == torch.float32
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits),
                               **LOGITS_TOL)
    loss, metrics = classification_loss(logits, torch.from_numpy(labels))
    assert abs(float(loss.detach()) - float(jl)) <= LOSS_TOL
    assert float(metrics["n_labels"]) == float(jm["n_labels"])
    assert abs(float(metrics["accuracy"]) - float(jm["accuracy"])) <= 1e-6
    # the head's names are the JAX package's (convert maps them as they are)
    assert sorted(convert.params_to_jax(dict(model.named_parameters()))) == \
        sorted(_named(params))


def test_adamw_matches_optax_over_3_steps():
    rng = np.random.default_rng(2)
    shapes = {"a": (6, 5), "b": (5,), "c": (3, 4)}
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
             for _ in range(3)]
    tx = optax.adamw(jax_linear(1e-2, 1, 3), weight_decay=0.05)
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = tx.init(jparams)
    ours = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    opt = AdamW(linear_warmup_linear_decay(1e-2, 1, 3), weight_decay=0.05)
    state = opt.init(ours)
    for step, g in enumerate(grads):
        upd, jstate = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                                jstate, jparams)
        jparams = optax.apply_updates(jparams, upd)
        state = opt.step(ours, {k: torch.from_numpy(v) for k, v in g.items()},
                         state)
        assert state.count == step + 1
        for k in shapes:
            np.testing.assert_allclose(ours[k].numpy(), np.asarray(jparams[k]),
                                       atol=1e-7, rtol=1e-6, err_msg=f"{step} {k}")
    # step 0 ran at lr 0 (warmup), the later ones moved every leaf
    assert all(not np.allclose(ours[k].numpy(), params[k]) for k in shapes)


def _word_tokenizer(words):
    """As tests/test_finetune.py: word i -> 1 + (len(word) > 3) tokens."""
    ids, word_ids = [2], [None]
    for wi, w in enumerate(words):
        for _ in range(2 if len(w) > 3 else 1):
            ids.append(5 + sum(map(ord, w)) % 100)
            word_ids.append(wi)
    ids.append(3)
    word_ids.append(None)
    return {"input_ids": ids, "word_ids": word_ids}


def _ner_examples(n, rng):
    examples = []
    for _ in range(n):
        length = int(rng.integers(3, 7))
        words = [f"w{rng.integers(0, 30)}" + "x" * int(rng.integers(0, 4))
                 for _ in range(length)]
        tags = [int(t) for t in rng.choice([0, 0, 1, 2, 3, 5], length)]
        examples.append({"tokens": words, "ner_tags": tags})
    return examples


def _ncc_examples(n):
    return [{"text": f"news story {i} " + "ab" * (i % 5), "label": i % 3}
            for i in range(n)]


def _tokenize_text(text):
    return [2] + [5 + (ord(c) % 50) for c in text[:20]] + [3]


def _init_like_jax(jmodel, data, bs, seed):
    """The JAX driver's initial weights (``model.init`` on the first batch
    from ``PRNGKey(seed)``), as a port ``init_weights`` stand-in."""
    rng = jax.random.PRNGKey(seed)
    sample = {k: jnp.asarray(v[:bs]) for k, v in data.items()}
    params = jmodel.init({"params": rng, "dropout": rng}, sample["input_ids"],
                         sample["attention_mask"], None,
                         deterministic=True)["params"]
    state = convert.params_from_jax(_named(params))

    def load(model, generator):
        model.load_state_dict(state)
        return model

    return load


@pytest.mark.parametrize("task", ["ner", "ncc"])
def test_runs_match_jax_epoch_by_epoch(task, monkeypatch):
    """Dropout 0 and fp32: each epoch's train and eval losses and the
    metric keys agree, and so do the early-stopping decisions. NER stops
    after its second epoch (threshold 10: no later epoch improves enough),
    so the restored best params are epoch 0's; NCC runs its 3 epochs."""
    rng = np.random.default_rng(3)
    jcfg = JaxConfig.tiny(vocab_size=128, max_position_embeddings=SEQ,
                          dtype=jnp.float32)
    cfg = AlbertConfig.tiny(vocab_size=128, max_position_embeddings=SEQ,
                            dtype=torch.float32)
    if task == "ner":
        train = FinetuneArguments(num_train_epochs=3, per_device_batch_size=4,
                                  learning_rate=1e-3, classifier_dropout=0.0,
                                  early_stopping_threshold=10.0, seed=5)
        args = ner.NerArguments(max_seq_length=SEQ, train=train)
        jargs = jax_ner.NerArguments(max_seq_length=SEQ, train=train)
        tr, ev = _ner_examples(10, rng), _ner_examples(6, rng)
        data = ner.encode_ner_examples(tr, _word_tokenizer, SEQ)
        jmodel = JaxTokModel(jcfg, num_labels=7, classifier_dropout=0.0)
        run = lambda: ner.run_ner(args, cfg, tr, ev, _word_tokenizer,
                                  device="cpu")
        jrun = lambda: jax_ner.run_ner(jargs, jcfg, tr, ev, _word_tokenizer)
        metric = "eval_f1"
    else:
        train = FinetuneArguments(num_train_epochs=3, per_device_batch_size=4,
                                  learning_rate=1e-3, classifier_dropout=0.0,
                                  early_stopping_patience=3, seed=5)
        args = ncc.NccArguments(max_seq_length=SEQ, train=train)
        jargs = jax_ncc.NccArguments(max_seq_length=SEQ, train=train)
        ex = _ncc_examples(14)
        tr, ev = ex[:10], ex[10:]
        data = ncc.encode_ncc_examples(tr, _tokenize_text, SEQ)
        jmodel = JaxSeqModel(jcfg, num_labels=3, classifier_dropout=0.0)
        labels = ["a", "b", "c"]
        run = lambda: ncc.run_ncc(args, cfg, tr, ev, _tokenize_text,
                                  label_list=labels, device="cpu")
        jrun = lambda: jax_ncc.run_ncc(jargs, jcfg, tr, ev, _tokenize_text,
                                       label_list=labels)
        metric = "eval_accuracy"
    monkeypatch.setattr(driver, "init_weights",
                        _init_like_jax(jmodel, data, 4, train.seed))
    best, history = run()
    jbest, jhistory = jrun()
    assert len(history) == len(jhistory) == (2 if task == "ner" else 3)
    for ours, theirs in zip(history, jhistory):
        assert sorted(ours) == sorted(theirs) and metric in ours
        for key in ("train_loss", "eval_loss"):
            assert abs(ours[key] - theirs[key]) <= EPOCH_LOSS_TOL, (key, ours, theirs)
    jnamed = _named(jbest)
    for name, value in convert.params_to_jax(best).items():
        np.testing.assert_allclose(value, jnamed[name], **PARAM_TOL, err_msg=name)


def test_finetune_restores_the_best_params():
    """The model ends holding the best epoch's params, and evaluating it
    gives that epoch's eval loss."""
    cfg = AlbertConfig.tiny(vocab_size=128, max_position_embeddings=SEQ,
                            dtype=torch.float32)
    ex = _ncc_examples(12)
    data = ncc.encode_ncc_examples(ex, _tokenize_text, SEQ)
    model = AlbertForSequenceClassification(cfg, num_labels=3)
    args = FinetuneArguments(num_train_epochs=2, per_device_batch_size=4,
                             learning_rate=1e-3, early_stopping_threshold=10.0)
    best, history = finetune(model, None, data, data, args, device="cpu")
    assert len(history) == 2  # the second epoch cannot improve by 10
    for name, p in model.named_parameters():
        assert torch.equal(p.detach(), best[name]), name
    loss, _preds = driver.evaluate(model, data, 4)
    assert loss == history[0]["eval_loss"]


def test_dropout_statistics():
    x = torch.ones(200_000)
    p = 0.1
    out = dropout(x, p, torch.Generator().manual_seed(0))
    kept = out != 0
    assert abs(float(kept.float().mean()) - (1 - p)) < 5e-3
    # what is kept is divided by the keep probability (in x's dtype)
    assert torch.equal(out[kept], torch.full_like(out[kept], 1 / np.float32(0.9)))
    again = dropout(x, p, torch.Generator().manual_seed(0))
    assert torch.equal(out, again)
    other = dropout(x, p, torch.Generator().manual_seed(1))
    assert not torch.equal(out, other)
    assert dropout(x, p, None) is x and dropout(x, 0.0, torch.Generator()) is x


def test_dropout_in_the_model():
    """Training mode draws from the explicit key: the same seed gives the
    same logits, another seed others; eval mode ignores it; remat replays
    the forward's masks, so its gradients equal those without remat."""
    cfg = AlbertConfig.tiny(vocab_size=128, max_position_embeddings=SEQ,
                            dtype=torch.float32, hidden_dropout_prob=0.1,
                            attention_dropout_prob=0.1)
    ids = torch.from_numpy(_inputs(np.random.default_rng(4))[0])
    labels = torch.tensor([0, 1, 2])
    runs = {}
    for remat in (True, False):
        model = AlbertForSequenceClassification(
            dataclasses.replace(cfg, remat=remat), num_labels=3)
        init_weights(model, torch.Generator().manual_seed(0))
        logits = model(ids, deterministic=False,
                       generator=torch.Generator().manual_seed(7))
        loss, _ = classification_loss(logits, labels)
        runs[remat] = (logits.detach(), torch.autograd.grad(
            loss, list(model.parameters())))
    assert torch.equal(runs[True][0], runs[False][0])
    for a, b in zip(runs[True][1], runs[False][1]):
        assert torch.equal(a, b)
    other = model(ids, deterministic=False,
                  generator=torch.Generator().manual_seed(8))
    assert not torch.allclose(other, runs[False][0])
    plain = model(ids)
    assert torch.equal(plain, model(ids, deterministic=True,
                                    generator=torch.Generator().manual_seed(7)))
    assert not torch.allclose(plain, runs[False][0])
    with pytest.raises(ValueError, match="needs a generator"):
        model(ids, deterministic=False)


def test_fused_attention_refuses_attention_dropout_in_training():
    cfg = AlbertConfig.tiny(attention_impl="flash", attention_dropout_prob=0.1)
    model = AlbertForTokenClassification(cfg, num_labels=3)
    ids = torch.zeros((1, 8), dtype=torch.long)
    with pytest.raises(ValueError, match="does not support attention dropout"):
        model(ids, deterministic=False, generator=torch.Generator())
    assert model(ids).shape == (1, 8, 3)  # eval mode runs


@pytest.fixture(scope="module")
def pretrained(tmp_path_factory):
    """A pretraining checkpoint of each package, as their trainers write
    it: the (params, opt_state) pair's params under ``[0]``."""
    jcfg = JaxConfig.tiny(vocab_size=128, max_position_embeddings=SEQ)
    params = jax.jit(JaxPreTraining(jcfg).init)(
        jax.random.PRNGKey(3), jnp.zeros((1, SEQ), jnp.int32))["params"]
    tmp_path = tmp_path_factory.mktemp("pretrained")
    jax_dir = tmp_path / "jax"
    save_checkpoint(str(jax_dir), 5, {"[0]" + k: v for k, v in
                                      _named(params).items()},
                    metadata={"local_step": 5})
    model = AlbertForPreTraining(AlbertConfig.tiny(vocab_size=128,
                                                   max_position_embeddings=SEQ))
    init_weights(model, torch.Generator().manual_seed(9))
    from dedloc_tpu_torch.models.convert import state_to_jax
    from dedloc_tpu_torch.optim.lamb import Lamb

    lamb = Lamb(1e-3)
    port_dir = tmp_path / "torch"
    named = state_to_jax(dict(model.named_parameters()),
                         lamb.init(dict(model.named_parameters())),
                         clip=False, schedule=False)
    save_checkpoint(str(port_dir), 3, named, metadata={"local_step": 3})
    return {"jax": (jax_dir, convert.params_from_jax(_named(params))),
            "torch": (port_dir, {k: v.detach() for k, v in
                                 model.state_dict().items()})}


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_warm_start_from_either_packages_checkpoint(pretrained, writer):
    path, want = pretrained[writer]
    init = ner.load_backbone_params(str(path))
    assert any(k.startswith("mlm_") for k in init)  # the whole params tree
    model = AlbertForTokenClassification(
        AlbertConfig.tiny(vocab_size=128, max_position_embeddings=SEQ), 7)
    data = ner.encode_ner_examples(_ner_examples(4, np.random.default_rng(0)),
                                   _word_tokenizer, SEQ)
    args = FinetuneArguments(num_train_epochs=0, per_device_batch_size=4)
    best, history = finetune(model, init, data, data, args, device="cpu")
    assert history == []
    backbone = [k for k in best if k.startswith("albert.")]
    assert len(backbone) == len([k for k in want if k.startswith("albert.")])
    for name in backbone:
        assert torch.equal(best[name], want[name]), name
    assert ner.load_backbone_params("") is None


def test_warm_start_rejects_a_shape_mismatch(pretrained):
    init = ner.load_backbone_params(str(pretrained["torch"][0]))
    grown = AlbertConfig.tiny(vocab_size=128, max_position_embeddings=2 * SEQ)
    model = AlbertForSequenceClassification(grown, num_labels=2)
    with pytest.raises(ValueError, match="position table|model config"):
        warm_start(model, init)


def test_finetune_without_cuda_raises_unless_the_cpu_is_asked_for():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    model = AlbertForSequenceClassification(AlbertConfig.tiny(), num_labels=2)
    data = ncc.encode_ncc_examples(_ncc_examples(4), _tokenize_text, SEQ)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        finetune(model, None, data, data, FinetuneArguments(num_train_epochs=1))


def _write_jsonl(path, rows):
    with open(path, "w") as f:
        for r in rows:
            f.write(json.dumps(r) + "\n")


def _tokenizer_file(tmp_path):
    from dedloc_tpu_torch.data.tokenizer import (
        FastTokenizer,
        train_unigram_tokenizer,
    )

    corpus = ["kolkata news story about sports",
              "national desk reports state politics",
              "entertainment world update international"] * 4
    path = str(tmp_path / "tokenizer.json")
    FastTokenizer(train_unigram_tokenizer(corpus, vocab_size=200)).save(path)
    return path


@pytest.mark.parametrize("task", ["ner", "ncc"])
def test_main_through_a_local_json_dataset(tmp_path, monkeypatch, task):
    """The CLI mains over ``datasets.load_dataset``'s local data-files path
    (tests/test_finetune.py), on the CPU by DEDLOC_FORCE_CPU."""
    monkeypatch.setenv("DEDLOC_FORCE_CPU", "1")
    ds = tmp_path / "ds"
    ds.mkdir()
    if task == "ner":
        rows = [{"tokens": ["kolkata", "reports", "sports"], "ner_tags": [5, 0, 0]},
                {"tokens": ["national", "desk"], "ner_tags": [3, 4]},
                {"tokens": ["state", "politics", "update"], "ner_tags": [0, 0, 0]},
                {"tokens": ["world", "news"], "ner_tags": [1, 2]}]
    else:
        rows = [{"text": "kolkata news story about sports", "label": 4},
                {"text": "national desk reports state politics", "label": 2},
                {"text": "entertainment world update", "label": 5},
                {"text": "international desk update", "label": 3}]
    _write_jsonl(ds / "train.jsonl", rows * 3)
    _write_jsonl(ds / "validation.jsonl", rows)
    history = []
    real = driver.finetune

    def recording(*a, **kw):
        out = real(*a, **kw)
        history.extend(out[1])
        return out

    monkeypatch.setattr((ner if task == "ner" else ncc), "finetune", recording)
    (ner if task == "ner" else ncc).main([
        "--dataset_name", str(ds),
        "--model_size", "tiny",
        "--max_seq_length", "24",
        "--tokenizer_path", _tokenizer_file(tmp_path),
        "--train.num_train_epochs", "1",
        "--train.per_device_batch_size", "4",
        "--train.learning_rate", "1e-3",
    ])
    assert len(history) == 1 and np.isfinite(history[0]["eval_loss"])
    assert ("eval_f1" if task == "ner" else "eval_accuracy") in history[0]

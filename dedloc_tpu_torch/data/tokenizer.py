"""SentencePiece-Unigram tokenizer pipeline + fast wrapper.

Capability parity with the reference's custom Bengali tokenizer
(sahajbert/tokenizer/tokenizer_model.py:9-87 — Unigram model with NMT/NFKC
normalization, Bengali danda/viserga unicode repairs, Metaspace+Digits+
Punctuation pre-tokenization, ``[CLS] $A [SEP] $B:1 [SEP]:1`` template — and
sahajbert/tokenization_albert_bengali_fast.py — the PreTrainedTokenizerFast
wrapper) built on the ``tokenizers`` wheel. The framework-side API is the
small ``FastTokenizer`` facade the data pipelines and fine-tune drivers
consume; transformers interop is one adapter call away.
"""
from __future__ import annotations

import logging
from typing import Dict, Iterable, List, Optional, Sequence

logger = logging.getLogger(__name__)

SPECIAL_TOKENS = ["<pad>", "<unk>", "[CLS]", "[SEP]", "[MASK]"]
PAD_ID, UNK_ID, CLS_ID, SEP_ID, MASK_ID = range(5)


def build_unigram_tokenizer(replacement: str = "▁", add_prefix_space: bool = True):
    """Untrained Unigram tokenizer with the Bengali-aware normalizer stack.

    Normalization repairs common Bengali unicode confusions before
    lowercasing (reference tokenizer_model.py:17-29): deprecated
    danda/double-danda codepoints and the ASCII pipe to U+0964, the Assamese
    riha to danda, and a colon following a Bengali char to the viserga.
    """
    from tokenizers import Regex, Tokenizer, decoders, normalizers, pre_tokenizers
    from tokenizers.models import Unigram
    from tokenizers.processors import TemplateProcessing

    tok = Tokenizer(Unigram())
    tok.normalizer = normalizers.Sequence(
        [
            normalizers.Nmt(),
            normalizers.NFKC(),
            normalizers.Replace(Regex(" {2,}"), " "),
            normalizers.Replace("৤", "।"),
            normalizers.Replace("৥", "॥"),
            normalizers.Replace("|", "।"),
            normalizers.Replace("৷", "।"),
            normalizers.Replace(Regex(r"(?<=[ঀ-৿]):"), "ঃ"),
            normalizers.Lowercase(),
        ]
    )
    tok.pre_tokenizer = pre_tokenizers.Sequence(
        [
            pre_tokenizers.Metaspace(
                replacement=replacement, prepend_scheme="always" if add_prefix_space else "never"
            ),
            pre_tokenizers.Digits(individual_digits=True),
            pre_tokenizers.Punctuation(),
        ]
    )
    tok.decoder = decoders.Metaspace(
        replacement=replacement, prepend_scheme="always" if add_prefix_space else "never"
    )
    tok.post_processor = TemplateProcessing(
        single="[CLS] $A [SEP]",
        pair="[CLS] $A [SEP] $B:1 [SEP]:1",
        special_tokens=[("[CLS]", CLS_ID), ("[SEP]", SEP_ID)],
    )
    return tok


def train_unigram_tokenizer(
    texts: Iterable[str],
    vocab_size: int = 8000,
    special_tokens: Sequence[str] = tuple(SPECIAL_TOKENS),
    show_progress: bool = False,
):
    """Train from any text iterator (the reference trains on OSCAR-bn with
    vocab 31,995, tokenizer_training_custom.py:1-31)."""
    from tokenizers import trainers
    from tokenizers.processors import TemplateProcessing

    if "[CLS]" not in special_tokens or "[SEP]" not in special_tokens:
        raise ValueError(
            "special_tokens must include [CLS] and [SEP] (required by the "
            f"post-processing template); got {list(special_tokens)}"
        )
    tok = build_unigram_tokenizer()
    trainer = trainers.UnigramTrainer(
        vocab_size=vocab_size,
        special_tokens=list(special_tokens),
        unk_token="<unk>",
        show_progress=show_progress,
    )
    tok.train_from_iterator(texts, trainer=trainer)
    # Rebuild the template with the ids the trainer actually assigned — a
    # caller-supplied special_tokens order must not silently desync the
    # [CLS]/[SEP] ids the post-processor emits.
    vocab = tok.get_vocab()
    tok.post_processor = TemplateProcessing(
        single="[CLS] $A [SEP]",
        pair="[CLS] $A [SEP] $B:1 [SEP]:1",
        special_tokens=[("[CLS]", vocab["[CLS]"]), ("[SEP]", vocab["[SEP]"])],
    )
    return tok


class FastTokenizer:
    """Thin facade over a trained ``tokenizers.Tokenizer``.

    The three call patterns the framework needs: plain text -> ids
    (streaming MLM pipeline), segment pairs (SOP instances), and
    pre-split words with word_ids (NER label alignment,
    train_ner.py:184-212).
    """

    def __init__(self, tokenizer):
        self.tokenizer = tokenizer
        vocab = tokenizer.get_vocab()
        self.pad_id = vocab.get("<pad>", PAD_ID)
        self.unk_id = vocab.get("<unk>", UNK_ID)
        self.cls_id = vocab.get("[CLS]", CLS_ID)
        self.sep_id = vocab.get("[SEP]", SEP_ID)
        self.mask_id = vocab.get("[MASK]", MASK_ID)

    @property
    def vocab_size(self) -> int:
        return self.tokenizer.get_vocab_size()

    def encode_ids(self, text: str, add_special_tokens: bool = True) -> List[int]:
        return self.tokenizer.encode(text, add_special_tokens=add_special_tokens).ids

    def encode_pair(self, a: str, b: str) -> Dict[str, List[int]]:
        enc = self.tokenizer.encode(a, b)
        return {"input_ids": enc.ids, "token_type_ids": enc.type_ids}

    def tokenize_words(self, words: List[str]) -> Dict[str, List]:
        enc = self.tokenizer.encode(words, is_pretokenized=True)
        return {"input_ids": enc.ids, "word_ids": enc.word_ids}

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = True) -> str:
        return self.tokenizer.decode(list(ids), skip_special_tokens=skip_special_tokens)

    def save(self, path: str) -> None:
        self.tokenizer.save(path)

    @classmethod
    def load(cls, path: str) -> "FastTokenizer":
        from tokenizers import Tokenizer

        return cls(Tokenizer.from_file(path))

    def to_transformers(self):
        """PreTrainedTokenizerFast adapter (the AlbertBengaliTokenizerFast
        capability, tokenization_albert_bengali_fast.py:19-103)."""
        from transformers import PreTrainedTokenizerFast

        return PreTrainedTokenizerFast(
            tokenizer_object=self.tokenizer,
            pad_token="<pad>",
            unk_token="<unk>",
            cls_token="[CLS]",
            sep_token="[SEP]",
            mask_token="[MASK]",
            model_max_length=512,
        )


def load_fast_tokenizer(path_or_dir: str) -> FastTokenizer:
    """Load tokenizer.json from a file path or a checkpoint directory."""
    import os

    path = path_or_dir
    if os.path.isdir(path_or_dir):
        path = os.path.join(path_or_dir, "tokenizer.json")
    return FastTokenizer.load(path)

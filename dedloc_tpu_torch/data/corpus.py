"""Zero-egress natural-language corpus extraction.

The reference trains on downloaded corpora — WikiText-103
(albert/tokenize_wikitext103.py:90-104) and streaming wiki+OSCAR
(sahajbert/dataset_streaming.py:116-139). The bench/dev environment for this
framework has no network egress, so this module harvests the human-written
English prose that is already on the machine: module/class/function
docstrings of every installed distribution and the stdlib, plus the .md/.rst
documentation files that ship inside site-packages. The output layout is the
one-document-per-line format that ``data/prepare.py`` and the streaming
pipeline consume, so the rest of the data path is identical to a real
downloaded corpus.

Run:
    python -m dedloc_tpu_torch.data.corpus \\
        --output data/corpus/train.txt \\
        --holdout_output data/corpus/holdout.txt --holdout_fraction 0.02

Deduplication is exact (hash of the normalized document); filtering keeps
multi-sentence prose (word count + letter-ratio heuristics) and drops
code-dominated docstrings so the MLM task sees natural language.
"""
from __future__ import annotations

import ast
import hashlib
import os
import re
import sys
import sysconfig
from dataclasses import dataclass, field
from typing import Iterable, Iterator, List, Optional

from dedloc_tpu_torch.core.config import parse_config
from dedloc_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

_WS = re.compile(r"\s+")
_WORD = re.compile(r"[A-Za-z]{2,}")
# reST/markdown markup that would otherwise leak into the corpus
_MARKUP = re.compile(
    r"(:param[^:]*:|:return[^:]*:|:rtype:|:raises[^:]*:|:type[^:]*:"
    r"|``+|\*\*+|^#+\s|^\.\. [a-z-]+::.*$|^={3,}$|^-{3,}$|^~{3,}$)",
    re.MULTILINE,
)


def default_roots() -> List[str]:
    """Stdlib + every site/dist-packages dir on this interpreter's path."""
    roots = [sysconfig.get_paths()["stdlib"]]
    try:
        import site

        roots.extend(site.getsitepackages())
    except Exception:  # noqa: BLE001 — site may be absent in embedded builds
        pass
    for p in sys.path:
        if p and os.path.isdir(p) and ("site-packages" in p or "dist-packages" in p):
            roots.append(p)
    seen, out = set(), []
    for r in roots:
        r = os.path.realpath(r)
        if r not in seen and os.path.isdir(r):
            seen.add(r)
            out.append(r)
    return out


def iter_source_files(roots: Iterable[str]) -> Iterator[str]:
    for root in roots:
        for dirpath, dirnames, filenames in os.walk(root):
            # tests and vendored test data are noise-heavy; node_modules can
            # be enormous inside jupyter-adjacent wheels
            dirnames[:] = [
                d
                for d in dirnames
                if d not in ("node_modules", "__pycache__", ".git")
            ]
            for name in filenames:
                if name.endswith((".py", ".md", ".rst", ".txt")):
                    yield os.path.join(dirpath, name)


def _clean(text: str) -> str:
    """Markup-strip + whitespace-normalize into a single corpus line."""
    text = _MARKUP.sub(" ", text)
    return _WS.sub(" ", text).strip()


def _is_prose(doc: str, min_words: int) -> bool:
    words = _WORD.findall(doc)
    if len(words) < min_words:
        return False
    letters = sum(c.isalpha() or c == " " for c in doc)
    if letters / max(len(doc), 1) < 0.72:  # code/tables are symbol-dense
        return False
    # sentence-ish: at least two terminators, so segment-pair/SOP packing
    # (data/mlm.py) gets a usable A/B split downstream
    return doc.count(". ") + doc.count("? ") + doc.count("! ") >= 2


def docstrings_from_source(source: str) -> Iterator[str]:
    """Every module/class/function docstring in a Python source blob."""
    try:
        tree = ast.parse(source)
    except SyntaxError:
        return
    for node in ast.walk(tree):
        if isinstance(
            node,
            (ast.Module, ast.ClassDef, ast.FunctionDef, ast.AsyncFunctionDef),
        ):
            doc = ast.get_docstring(node, clean=True)
            if doc:
                # cut doctest blocks: everything from the first >>> onward
                cut = doc.find(">>>")
                yield doc[:cut] if cut >= 0 else doc


def documents_from_file(path: str) -> Iterator[str]:
    try:
        with open(path, encoding="utf-8", errors="ignore") as f:
            blob = f.read(4 << 20)
    except OSError:
        return
    if path.endswith(".py"):
        yield from docstrings_from_source(blob)
    else:
        # doc files: paragraphs (blank-line separated) as documents, so one
        # README becomes several coherent multi-sentence docs
        for para in re.split(r"\n\s*\n", blob):
            if not para.lstrip().startswith((">>>", "    ", "\t", "|", "+--")):
                yield para


def harvest(
    roots: Optional[List[str]] = None,
    min_words: int = 40,
    max_docs: int = 0,
) -> Iterator[str]:
    """Deduplicated prose documents, one string per document."""
    seen = set()
    count = 0
    for path in iter_source_files(roots or default_roots()):
        for raw in documents_from_file(path):
            doc = _clean(raw)
            if not _is_prose(doc, min_words):
                continue
            key = hashlib.md5(doc.lower().encode()).digest()
            if key in seen:
                continue
            seen.add(key)
            yield doc
            count += 1
            if max_docs and count >= max_docs:
                return


@dataclass
class CorpusArguments:
    output: str = "data/corpus/train.txt"
    holdout_output: str = ""  # optional eval split path
    holdout_fraction: float = 0.0
    min_words: int = 40
    max_docs: int = 0  # 0 = everything
    roots: List[str] = field(default_factory=list)  # empty = auto-discover
    seed: int = 0


def run_corpus(args: CorpusArguments) -> int:
    import random

    rng = random.Random(args.seed)
    os.makedirs(os.path.dirname(args.output) or ".", exist_ok=True)
    hold = None
    if args.holdout_output and args.holdout_fraction > 0:
        os.makedirs(os.path.dirname(args.holdout_output) or ".", exist_ok=True)
        hold = open(args.holdout_output, "w", encoding="utf-8")
    n = n_hold = chars = 0
    with open(args.output, "w", encoding="utf-8") as out:
        for doc in harvest(args.roots or None, args.min_words, args.max_docs):
            if hold is not None and rng.random() < args.holdout_fraction:
                hold.write(doc + "\n")
                n_hold += 1
            else:
                out.write(doc + "\n")
                n += 1
                chars += len(doc)
    if hold is not None:
        hold.close()
    logger.info(
        f"corpus: {n} train docs ({chars / 1e6:.1f} MB), {n_hold} holdout"
    )
    return n


def main(argv=None) -> None:
    run_corpus(parse_config(CorpusArguments, argv))


if __name__ == "__main__":
    main()

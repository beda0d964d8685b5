"""The port's host text stages against the JAX package on the CPU: the
stemmers and the tokenizer's ``stemming``/``language``, the count
vectorizer, n-grams, stop words and IDF, the language, entity, MIME,
phone, email and URL stages, the text-to-set and regex tokenizers, the
math module's stages, and save/load across the packages.

Inputs: every string constant of ``tests/test_text_stages.py`` and
``tests/test_nlp_accuracy.py`` (read from their syntax trees, so each of
their fixture strings goes through both packages and the outputs are
compared, not copied), their MIME byte fixtures and every byte string
they spell out, base64-encoded, and seeded token lists and numbers.
Tolerance: none (values, masks and vector metadata equal).
"""
from __future__ import annotations

import ast
import base64
import dataclasses
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np  # noqa: E402
import pandas as pd  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
for p in (REPO, HERE):
    if p not in sys.path:
        sys.path.insert(0, p)

import test_nlp_accuracy as nlp  # noqa: E402
from transmogrifai_tpu import types as JT  # noqa: E402
from transmogrifai_tpu.features import (  # noqa: E402
    FeatureBuilder as JFB, reset_uids as jax_reset,
)
from transmogrifai_tpu.impl.feature import (  # noqa: E402
    math as JM, text as JX, vectorizers as JV,
)
from transmogrifai_tpu.table import (  # noqa: E402
    Column as JColumn, FeatureTable as JTable,
)
from transmogrifai_tpu_torch import types as PT  # noqa: E402
from transmogrifai_tpu_torch.features import (  # noqa: E402
    FeatureBuilder as PFB, reset_uids as port_reset,
)
from transmogrifai_tpu_torch.impl.feature import (  # noqa: E402
    math as PM, text as PX, vectorizers as PV,
)
from transmogrifai_tpu_torch.table import (  # noqa: E402
    Column as PColumn, FeatureTable as PTable,
)


def _constants(kind):
    out = []
    for name in ("test_text_stages.py", "test_nlp_accuracy.py"):
        with open(os.path.join(HERE, name), encoding="utf-8") as fh:
            tree = ast.parse(fh.read())
        out += [n.value for n in ast.walk(tree)
                if isinstance(n, ast.Constant) and isinstance(n.value, kind)]
    return out


#: every string constant of the two JAX test files, once, in order
STRINGS = list(dict.fromkeys(_constants(str)))
#: their byte strings, the MIME fixtures' files and the strings' UTF-8
#: bytes, base64-encoded
_FILES = ([b for b, _ in nlp.MIME_FIXTURES] +
          [b for b, _ in nlp.MIME_FIXTURES_R4] + _constants(bytes) +
          [s.encode("utf-8") for s in STRINGS[:400]])
BASE64 = list(dict.fromkeys(base64.b64encode(b).decode("ascii")
                            for b in _FILES)) + ["AAAA", "!!notb64", ""]
REGIONS = ["US", "GB", "DE", "FR", "IN", "BR", "JP", "CN", "AU", "XX"]
REGION_TEXTS = ["US", "United States", "UK", "United Kingdom", "Germany",
                "deutschland", "France", "India", "Brasil", "Europe",
                "Narnia", "", None]


def host(a):
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _value(v):
    if isinstance(v, np.ndarray):
        return v.tolist()
    if isinstance(v, np.generic):
        return v.item()
    if isinstance(v, (set, frozenset)):
        return sorted(v)
    if isinstance(v, dict):
        return {k: _value(x) for k, x in v.items()}
    return v


def assert_same_column(jc, pc):
    jv, pv = host(jc.values), host(pc.values)
    if jv.dtype == object or pv.dtype == object:
        assert [_value(v) for v in pv] == [_value(v) for v in jv]
    else:
        np.testing.assert_array_equal(pv, jv)
        assert pv.dtype == jv.dtype
    ones = np.ones(len(jv), bool)
    jm = ones if jc.mask is None else host(jc.mask).astype(bool)
    pm = ones if pc.mask is None else host(pc.mask).astype(bool)
    np.testing.assert_array_equal(pm, jm)
    jvm, pvm = (c.metadata.get("vector_meta") for c in (jc, pc))
    assert (jvm is None) == (pvm is None)
    if jvm is not None:
        assert pvm.name == jvm.name
        assert [dataclasses.asdict(c) for c in pvm.columns] == \
            [dataclasses.asdict(c) for c in jvm.columns]


def run_both(mods, cls, kw, inputs, fit=False):
    """(JAX stage, JAX column, port stage, port column): ``cls`` of the
    modules ``mods`` (JAX, port) built with ``kw`` (or by ``kw(module)``
    when callable) on columns ``inputs`` ({name: (type name, rows)}),
    fitted first when ``fit``; both DAGs built after ``reset_uids``."""
    out = []
    for m, FB, reset, Col, Tab, T in (
            (mods[0], JFB, jax_reset, JColumn, JTable, JT),
            (mods[1], PFB, port_reset, PColumn, PTable, PT)):
        reset()
        feats, cols = [], {}
        for name, (tn, rows) in inputs.items():
            ft = T.FEATURE_TYPES[tn]
            feats.append(FB(name, ft).extract_field().as_predictor())
            cols[name] = Col.of_values(ft, rows)
        n = len(next(iter(inputs.values()))[1])
        t = Tab(cols, n)
        stage = (kw(m) if callable(kw) else getattr(m, cls)(**kw))
        stage = stage.set_input(*feats)
        if fit:
            stage = stage.fit(t)
        out += [stage, stage.transform_column(t)]
    return out


TEXT = {"f": ("Text", STRINGS + [None])}


def _tokens(seed=0, n=300):
    """Token lists from the strings (stemmed and not), seeded, with
    missing and empty rows."""
    rng = np.random.RandomState(seed)
    toks = [PV.tokenize_text(s) for s in STRINGS]
    out = []
    for i in range(n):
        if rng.rand() < 0.05:
            out.append(None)
            continue
        a = toks[rng.randint(len(toks))]
        b = toks[rng.randint(len(toks))]
        out.append(list(a[: rng.randint(0, 12)]) + list(b[:4]))
    return out


# ---------------------------------------------------------------------------
# Stemmers and the tokenizer
# ---------------------------------------------------------------------------

def test_stemmers_are_the_jax_packages():
    assert sorted(PV.STEMMERS) == sorted(JV.STEMMERS)
    words = sorted({t for s in STRINGS for t in PV.tokenize_text(s)})
    assert len(words) > 500
    for lang in JV.STEMMERS:
        got = [PV.STEMMERS[lang](w) for w in words]
        assert got == [JV.STEMMERS[lang](w) for w in words], lang


@pytest.mark.parametrize("stemming,language", [
    (False, "en"), (True, "en"), (True, "fr"), (True, "de"), (True, "ru"),
    (True, "cs"), (True, "xx")])
def test_tokenizer_stemming_and_language(stemming, language):
    js, jc, ps, pc = run_both((JV, PV), "TextTokenizer",
                              dict(min_token_length=2, stemming=stemming,
                                   language=language), TEXT)
    assert_same_column(jc, pc)
    assert (ps.stemming, ps.language) == (js.stemming, js.language)
    for s in STRINGS[:50]:
        assert ps.transform_row({"f": s}) == js.transform_row({"f": s})


# ---------------------------------------------------------------------------
# Count vectors, n-grams, stop words, IDF
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [dict(), dict(vocab_size=20, min_df=2),
                                dict(vocab_size=7, binary=True),
                                dict(min_df=1000)])
def test_count_vectorizer(kw):
    js, jc, ps, pc = run_both((JX, PX), "OpCountVectorizer", kw,
                              {"f": ("TextList", _tokens())}, fit=True)
    assert ps.vocab == js.vocab
    assert_same_column(jc, pc)


@pytest.mark.parametrize("n", [1, 2, 3])
def test_ngram(n):
    _, jc, _, pc = run_both((JX, PX), "OpNGram", dict(n=n),
                            {"f": ("TextList", _tokens(1))})
    assert_same_column(jc, pc)


@pytest.mark.parametrize("kw", [dict(), dict(case_sensitive=True),
                                dict(stop_words=["The", "de", "и"]),
                                dict(stop_words=["The", "de"],
                                     case_sensitive=True)])
def test_stop_words(kw):
    rows = [None if t is None else [w.upper() if i % 3 == 0 else w
                                    for i, w in enumerate(t)]
            for t in _tokens(2)]
    _, jc, _, pc = run_both((JX, PX), "OpStopWordsRemover", kw,
                            {"f": ("TextList", rows)})
    assert_same_column(jc, pc)
    assert PX.ENGLISH_STOP_WORDS == JX.ENGLISH_STOP_WORDS


@pytest.mark.parametrize("min_doc_freq", [0, 3, 50])
def test_idf(min_doc_freq):
    rng = np.random.RandomState(min_doc_freq)
    X = (rng.poisson(0.4, (200, 30)) * (rng.rand(200, 30) < 0.5)
         ).astype(np.float32)
    js, jc, ps, pc = run_both((JX, PX), "OpIDF",
                              dict(min_doc_freq=min_doc_freq),
                              {"f": ("OPVector", [list(r) for r in X])},
                              fit=True)
    np.testing.assert_array_equal(host(ps.idf), host(js.idf))
    assert ps.summary_metadata == js.summary_metadata
    np.testing.assert_array_equal(host(pc.values), host(jc.values))
    assert ps.transform_fn(list(X[3])) == js.transform_fn(list(X[3]))
    assert ps.transform_fn(None) is js.transform_fn(None) is None


def test_idf_keeps_the_count_vectors_metadata():
    rows = _tokens(3)
    for m, FB, reset, Col, Tab, T in (
            (JX, JFB, jax_reset, JColumn, JTable, JT),
            (PX, PFB, port_reset, PColumn, PTable, PT)):
        reset()
        f = FB("f", T.TextList).extract_field().as_predictor()
        t = Tab({"f": Col.of_values(T.TextList, rows)}, len(rows))
        cv = m.OpCountVectorizer(vocab_size=40).set_input(f).fit(t)
        t = t.with_column(cv.get_output().name, cv.transform_column(t))
        idf = m.OpIDF().set_input(cv.get_output()).fit(t)
        out = idf.transform_column(t)
        if m is JX:
            want = out
        else:
            assert_same_column(want, out)


# ---------------------------------------------------------------------------
# Parsers: language, entities, MIME, phones, email, URL
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cls", [
    "LangDetector", "NameEntityRecognizer", "ValidEmailTransformer",
    "EmailToPickList", "EmailToPrefix", "UrlToDomain", "IsValidUrl",
    "UrlToProtocol", "TextToMultiPickList"])
def test_string_stage_on_every_fixture_string(cls):
    in_type = {"ValidEmailTransformer": "Email", "EmailToPickList": "Email",
               "EmailToPrefix": "Email", "UrlToDomain": "URL",
               "IsValidUrl": "URL", "UrlToProtocol": "URL"}.get(cls, "Text")
    _, jc, _, pc = run_both((JX, PX), cls, {},
                            {"f": (in_type, STRINGS + [None, ""])})
    assert_same_column(jc, pc)


def test_language_profiles_are_the_jax_packages():
    assert PX._STOPWORD_PROFILES == JX._STOPWORD_PROFILES
    assert PX._CUE_TOKENS == JX._CUE_TOKENS
    assert PX._CUE_CHARS == JX._CUE_CHARS
    assert PX._SCRIPT_LANGS == JX._SCRIPT_LANGS
    assert (PX._UR_CHARS, PX._FA_CHARS) == (JX._UR_CHARS, JX._FA_CHARS)
    assert all(PX._strip_marks(s) == JX._strip_marks(s) for s in STRINGS)


def test_mime_detector_on_every_fixture_file():
    _, jc, _, pc = run_both((JX, PX), "MimeTypeDetector", {},
                            {"f": ("Base64", BASE64 + [None])})
    assert_same_column(jc, pc)


@pytest.mark.parametrize("kw", [
    dict(pattern=r"\w+"), dict(pattern=r"[a-z]+", to_lowercase=False),
    dict(pattern=r"(\w)(\w+)", min_token_length=3)])
def test_regex_tokenizer(kw):
    _, jc, _, pc = run_both((JX, PX), "RegexTokenizer", kw, TEXT)
    assert_same_column(jc, pc)


def _phones():
    rng = np.random.RandomState(4)
    made = ["".join(str(d) for d in rng.randint(0, 10, rng.randint(2, 15)))
            for _ in range(300)]
    made += ["+" + m for m in made[:100]] + ["0" + m for m in made[100:200]]
    return list(dict.fromkeys(STRINGS + made))


@pytest.mark.parametrize("region", REGIONS)
@pytest.mark.parametrize("strict", [False, True])
def test_phone_functions(region, strict):
    for v in _phones() + [None, ""]:
        assert PX.parse_phone(v, region, strict=strict) == \
            JX.parse_phone(v, region, strict=strict), v
        assert PX.phone_number_type(v, region) == \
            JX.phone_number_type(v, region), v


@pytest.mark.parametrize("cls", ["PhoneNumberParser",
                                 "IsValidPhoneDefaultCountry"])
@pytest.mark.parametrize("region,strict", [("US", False), ("GB", True),
                                           ("DE", False)])
def test_phone_stages(cls, region, strict):
    _, jc, _, pc = run_both((JX, PX), cls,
                            dict(default_region=region, strict=strict),
                            {"f": ("Phone", _phones() + [None])})
    assert_same_column(jc, pc)


@pytest.mark.parametrize("cls", ["ParsePhoneNumber", "IsValidPhoneNumber"])
@pytest.mark.parametrize("kw", [dict(), dict(strict=True),
                                dict(codes_and_countries={
                                    "DE": "GERMANY", "FR": "FRANCE"})])
def test_phone_with_region_stages(cls, kw):
    phones = _phones()
    rows_p = [phones[i % len(phones)] for i in range(600)] + [None]
    rows_r = [REGION_TEXTS[i % len(REGION_TEXTS)] for i in range(601)]
    _, jc, _, pc = run_both((JX, PX), cls, kw,
                            {"p": ("Phone", rows_p), "r": ("Text", rows_r)})
    assert_same_column(jc, pc)
    for t in REGION_TEXTS + STRINGS[:200]:
        assert PX._resolve_region(t, "US") == JX._resolve_region(t, "US")


def test_is_valid_phone_map():
    phones = _phones()
    rows = [None if i % 17 == 0 else
            {f"k{j}": phones[(i * 3 + j) % len(phones)] for j in range(i % 4)}
            for i in range(300)]
    _, jc, _, pc = run_both((JX, PX), "IsValidPhoneMap",
                            dict(default_region="GB"),
                            {"f": ("PhoneMap", rows)})
    assert_same_column(jc, pc)


# ---------------------------------------------------------------------------
# The math module's stages
# ---------------------------------------------------------------------------

def _reals(seed=5, n=400):
    rng = np.random.RandomState(seed)
    v = np.concatenate([rng.randn(n // 2) * 10, rng.rand(n // 2) * 1e3,
                        [0.0, -0.0, -1.0, 1.0, 0.5, -0.5, 2.5, 1e30]])
    return [None if rng.rand() < 0.1 else float(x) for x in v]


@pytest.mark.parametrize("fn,args", [
    ("AbsoluteValue", ()), ("Ceil", ()), ("Floor", ()),
    ("RoundTransformer", ()), ("Exp", ()), ("Sqrt", ()), ("Log", ()),
    ("Log", (10.0,)), ("Power", (2.0,)), ("Power", (0.5,)),
    ("SquareRoot", ())])
def test_numeric_unaries(fn, args):
    js, jc, ps, pc = run_both((JM, PM), fn, lambda m: getattr(m, fn)(*args),
                              {"f": ("Real", _reals())})
    assert_same_column(jc, pc)
    for v in _reals(6, 40):
        assert ps.transform_row({"f": v}) == js.transform_row({"f": v})


def _pairs():
    s = STRINGS[:300]
    return {"a": ("Text", s + [None, "x"]),
            "b": ("Text", [s[(i * 7) % len(s)][:5] for i in range(len(s))]
                  + ["x", None])}


def test_substring_and_ngram_similarity():
    for cls, kw in (("SubstringTransformer", {}), ("NGramSimilarity", {}),
                    ("NGramSimilarity", dict(n=2))):
        _, jc, _, pc = run_both((JM, PM), cls, kw, _pairs())
        assert_same_column(jc, pc)


def test_jaccard_similarity():
    toks = _tokens(7)
    _, jc, _, pc = run_both((JM, PM), "JaccardSimilarity", {}, {
        "a": ("TextList", toks), "b": ("TextList", toks[::-1])})
    assert_same_column(jc, pc)
    for a, b in zip(toks, toks[1:]):
        assert PM.jaccard_similarity(a, b) == JM.jaccard_similarity(a, b)


@pytest.mark.parametrize("type_name,rows", [
    ("Real", _reals()), ("Text", STRINGS[:100] + [None, ""]),
    ("TextList", _tokens(8, 100))])
def test_to_occur_and_text_len(type_name, rows):
    _, jc, _, pc = run_both((JM, PM), "ToOccurTransformer", {},
                            {"f": (type_name, rows)})
    assert_same_column(jc, pc)
    _, jc, _, pc = run_both((JM, PM), "ToOccurTransformer",
                            lambda m: m.ToOccurTransformer(
                                lambda v: v is not None and len(str(v)) > 4),
                            {"f": (type_name, rows)})
    assert_same_column(jc, pc)
    if type_name == "Text":
        _, jc, _, pc = run_both((JM, PM), "TextLenTransformer", {},
                                {"f": (type_name, rows)})
        assert_same_column(jc, pc)


def test_text_list_nulls_and_drop_indices():
    toks = _tokens(9)
    _, jc, _, pc = run_both((JM, PM), "TextListNullTransformer", {}, {
        "a": ("TextList", toks), "b": ("TextList", toks[::-1])})
    assert_same_column(jc, pc)
    for m, FB, reset, Col, Tab, T, V in (
            (JM, JFB, jax_reset, JColumn, JTable, JT, JV),
            (PM, PFB, port_reset, PColumn, PTable, PT, PV)):
        reset()
        a = FB("a", T.Real).extract_field().as_predictor()
        b = FB("b", T.Real).extract_field().as_predictor()
        t = Tab({"a": Col.of_values(T.Real, _reals(1, 50)),
                 "b": Col.of_values(T.Real, _reals(2, 50))}, 58)
        vec = V.RealVectorizer().set_input(a, b).fit(t)
        t = t.with_column(vec.get_output().name, vec.transform_column(t))
        drop = m.DropIndicesByTransformer(
            lambda c: c.indicator_value is not None).set_input(
                vec.get_output())
        out = drop.transform_column(t)
        if m is JM:
            want = out
        else:
            assert_same_column(want, out)


@pytest.mark.parametrize("cls,type_name,rows", [
    ("OPListTransformer", "TextList", _tokens(10, 80)),
    ("OPSetTransformer", "MultiPickList",
     [None, ["a", "b"], [], ["c"]] * 10),
    ("OPMapTransformer", "TextMap",
     [None, {"k": "Abc"}, {}, {"k": "x", "j": "Y"}] * 10)])
def test_collection_transformers(cls, type_name, rows):
    def build(m):
        kw = dict(output_type=(JT if m is JM else PT).TextMap) \
            if cls == "OPMapTransformer" else {}
        return getattr(m, cls)(str.upper, **kw)
    _, jc, _, pc = run_both((JM, PM), cls, build, {"f": (type_name, rows)})
    assert_same_column(jc, pc)


# ---------------------------------------------------------------------------
# Saves across the packages
# ---------------------------------------------------------------------------

def _save_workflow(ns_fb, mods, T, tokenizer):
    """A workflow of this file's stages over raw text, email, URL, phone
    and region fields; the same uids in both packages after reset."""
    X, M = mods
    FB = ns_fb
    t = FB.Text("t").extract_field().as_predictor()
    e = FB.Email("e").extract_field().as_predictor()
    u = FB.URL("u").extract_field().as_predictor()
    p = FB.Phone("p").extract_field().as_predictor()
    r = FB.Text("r").extract_field().as_predictor()
    b = FB.Base64("b").extract_field().as_predictor()
    x = FB.Real("x").extract_field().as_predictor()
    toks = tokenizer(stemming=True, language="en").set_input(t).get_output()
    clean = X.OpStopWordsRemover().set_input(toks).get_output()
    counts = X.OpCountVectorizer(vocab_size=30).set_input(clean).get_output()
    return [
        X.OpIDF().set_input(counts).get_output(),
        X.OpNGram(2).set_input(clean).get_output(),
        X.OpWord2Vec(vector_size=8, steps=5, min_count=1
                     ).set_input(clean).get_output(),
        X.OpLDA(k=3, max_iter=2).set_input(counts).get_output(),
        X.LangDetector().set_input(t).get_output(),
        X.NameEntityRecognizer().set_input(t).get_output(),
        X.MimeTypeDetector().set_input(b).get_output(),
        X.PhoneNumberParser().set_input(p).get_output(),
        X.IsValidPhoneDefaultCountry().set_input(p).get_output(),
        X.ParsePhoneNumber().set_input(p, r).get_output(),
        X.IsValidPhoneNumber().set_input(p, r).get_output(),
        X.ValidEmailTransformer().set_input(e).get_output(),
        X.EmailToPickList().set_input(e).get_output(),
        X.EmailToPrefix().set_input(e).get_output(),
        X.UrlToDomain().set_input(u).get_output(),
        X.IsValidUrl().set_input(u).get_output(),
        X.UrlToProtocol().set_input(u).get_output(),
        X.TextToMultiPickList().set_input(t).get_output(),
        X.RegexTokenizer(r"[a-z]+").set_input(t).get_output(),
        M.Log(10.0).set_input(x).get_output(),
        M.TextLenTransformer().set_input(t).get_output(),
        M.JaccardSimilarity().set_input(toks, clean).get_output(),
        M.NGramSimilarity().set_input(t, r).get_output(),
        M.SubstringTransformer().set_input(t, r).get_output(),
    ]


def _save_records(n=120):
    rng = np.random.RandomState(11)
    phones = _phones()
    return [{"id": str(i), "t": STRINGS[(i * 13) % len(STRINGS)],
             "e": ["a@x.com", "bad", None, "b.c@y.org"][i % 4],
             "u": ["https://a.b/c", "nope", None, "ftp://x.io"][i % 4],
             "p": phones[i % len(phones)],
             "r": REGION_TEXTS[i % len(REGION_TEXTS)],
             "b": BASE64[i % len(BASE64)],
             "x": float(rng.rand() * 100)} for i in range(n)]


def test_saves_cross_both_packages(tmp_path):
    """JAX save -> port load and port save -> JAX load give the saving
    model's outputs; the plans have the same stages, classes and state
    keys; the port's reload gives its own outputs bit for bit."""
    sys.path.insert(0, HERE)
    import transmogrifai_tpu_torch as port
    from test_torch_serve import save_jax_model
    from transmogrifai_tpu.persistence import load_model as jax_load
    from transmogrifai_tpu.workflow import OpWorkflow as JW
    from transmogrifai_tpu_torch.workflow import OpWorkflow as PW
    recs = _save_records()
    df = pd.DataFrame(recs)
    jax_reset()
    jres = _save_workflow(JFB, (JX, JM), JT, JV.TextTokenizer)
    jwf = JW().set_input_dataset(df, key_field="id").set_result_features(
        *jres)
    jm = jwf.train()
    port_reset()
    pres = _save_workflow(PFB, (PX, PM), PT, PV.TextTokenizer)
    pwf = PW(device="cpu").set_input_dataset(recs, key_field="id") \
        .set_result_features(*pres)
    pm = pwf.train()
    jpath, ppath = str(tmp_path / "jax"), str(tmp_path / "port")
    save_jax_model(jm, jpath)
    pm.save(ppath)

    def outputs(scored, feats):
        return [scored[f.name] for f in feats]
    want = outputs(jm.score(df=df), jres)
    mine = outputs(pm.score(data=recs), pres)
    for a, b in zip(want, mine):
        assert_same_column(a, b)
    loaded = port.load_model(jpath, device="cpu", workflow=pwf)
    for a, b in zip(want, outputs(loaded.score(data=recs), pres)):
        assert_same_column(a, b)
    back = jax_load(ppath, workflow=jwf)
    for a, b in zip(outputs(back.score(df=df), jres), mine):
        assert_same_column(a, b)
    again = port.load_model(ppath, device="cpu", workflow=pwf)
    for a, b in zip(mine, outputs(again.score(data=recs), pres)):
        assert_same_column(a, b)

    import json

    def layout(path):
        with open(os.path.join(path, "plan.json")) as fh:
            plan = json.load(fh)
        return [(d["module"], d["className"], d["uid"], sorted(d["state"]))
                for d in plan["stages"] + plan["rawFeatureGenerators"]]
    assert layout(ppath) == layout(jpath)

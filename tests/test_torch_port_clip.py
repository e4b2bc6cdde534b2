"""The port's CLIP towers, importer, wrapper, image preprocessing and BPE tokenizer against
the JAX package's, on the CPU in fp32.

One OpenAI CLIP ``state_dict`` at ``tests/test_clip.py``'s ``TINY`` size (registered under
a test name in both packages' ``CLIP_CONFIGS``), synthesized from the key patterns of
``pcdiff/models/clip.py``'s importer with every tensor nonzero, goes into the JAX package
through its importer and into the port through its own and, again, through
``params_from_flax``. The JAX side runs the fused graph (``set_ln_dense_fusion("on")``).
Tolerance 1e-5. The tokenizer's Python and native merge loops are held token for token to
the JAX package's on a synthetic merges file.
"""

import jax
import numpy as np
import pytest
import torch

from pcdiff.models import attention as jattn
from pcdiff.models import clip as jclip
from pcdiff.tokenizer import SimpleTokenizer as JTokenizer
from pcdiff_torch.core import flax_from_params, params_from_flax
from pcdiff_torch.models import clip as tclip
from pcdiff_torch.tokenizer import SimpleTokenizer as TTokenizer
from pcdiff_torch.tokenizer import bpe as tbpe

torch.set_num_threads(1)  # one intra-op thread: the suite's xdist workers share the cores

NAME = "tiny-test"
KW = dict(embed_dim=16, image_resolution=32, vision_width=32, vision_layers=2,
          vision_patch=16, text_width=32, text_layers=2, text_heads=4, vocab_size=64,
          context_length=12, vision_heads=4)
B = 3


@pytest.fixture(autouse=True)
def _tiny(monkeypatch):
    jattn.set_ln_dense_fusion("on")
    monkeypatch.setitem(jclip.CLIP_CONFIGS, NAME, jclip.CLIPConfig(**KW))
    monkeypatch.setitem(tclip.CLIP_CONFIGS, NAME, tclip.CLIPConfig(**KW))
    yield
    jattn.set_ln_dense_fusion("auto")


def _block(sd, rng, prefix, w):
    def lin(name, out_f, in_f):
        sd[f"{prefix}.{name}.weight"] = (rng.standard_normal((out_f, in_f)) / np.sqrt(in_f)
                                         ).astype(np.float32)
        sd[f"{prefix}.{name}.bias"] = (0.1 * rng.standard_normal(out_f)).astype(np.float32)

    for ln in ("ln_1", "ln_2"):
        sd[f"{prefix}.{ln}.weight"] = (1 + 0.1 * rng.standard_normal(w)).astype(np.float32)
        sd[f"{prefix}.{ln}.bias"] = (0.1 * rng.standard_normal(w)).astype(np.float32)
    sd[f"{prefix}.attn.in_proj_weight"] = (rng.standard_normal((3 * w, w)) / np.sqrt(w)
                                           ).astype(np.float32)
    sd[f"{prefix}.attn.in_proj_bias"] = (0.1 * rng.standard_normal(3 * w)).astype(np.float32)
    lin("attn.out_proj", w, w)
    lin("mlp.c_fc", 4 * w, w)
    lin("mlp.c_proj", w, 4 * w)


def openai_state(seed=0):
    """An OpenAI CLIP ``state_dict`` at ``KW``'s size (numpy), every tensor nonzero, with
    the buffers of the published checkpoints that neither importer reads."""
    rng = np.random.default_rng(seed)
    w, wt, e, p = KW["vision_width"], KW["text_width"], KW["embed_dim"], KW["vision_patch"]
    g2 = (KW["image_resolution"] // p) ** 2
    sd = {"visual.conv1.weight": (rng.standard_normal((w, 3, p, p)) / (p * np.sqrt(3))
                                  ).astype(np.float32),
          "visual.class_embedding": (0.3 * rng.standard_normal(w)).astype(np.float32),
          "visual.positional_embedding": (0.3 * rng.standard_normal((g2 + 1, w))
                                          ).astype(np.float32),
          "visual.proj": (rng.standard_normal((w, e)) / np.sqrt(w)).astype(np.float32),
          "token_embedding.weight": (0.3 * rng.standard_normal((KW["vocab_size"], wt))
                                     ).astype(np.float32),
          "positional_embedding": (0.3 * rng.standard_normal((KW["context_length"], wt))
                                   ).astype(np.float32),
          "text_projection": (rng.standard_normal((wt, e)) / np.sqrt(wt)).astype(np.float32),
          "logit_scale": np.array(4.6052, np.float32),
          "input_resolution": np.array(KW["image_resolution"]),
          "context_length": np.array(KW["context_length"]),
          "vocab_size": np.array(KW["vocab_size"])}
    for ln, c in (("visual.ln_pre", w), ("visual.ln_post", w), ("ln_final", wt)):
        sd[f"{ln}.weight"] = (1 + 0.1 * rng.standard_normal(c)).astype(np.float32)
        sd[f"{ln}.bias"] = (0.1 * rng.standard_normal(c)).astype(np.float32)
    for i in range(KW["vision_layers"]):
        _block(sd, rng, f"visual.transformer.resblocks.{i}", w)
    for i in range(KW["text_layers"]):
        _block(sd, rng, f"transformer.resblocks.{i}", wt)
    return sd


@pytest.fixture(scope="module")
def state():
    sd = openai_state()
    return sd, jclip_import(sd), tclip_import(sd)


def jclip_import(sd):
    cfgs = dict(jclip.CLIP_CONFIGS)
    jclip.CLIP_CONFIGS[NAME] = jclip.CLIPConfig(**KW)
    try:
        return jclip.import_clip_torch_state(
            {k: v for k, v in sd.items() if k not in ("input_resolution", "context_length",
                                                       "vocab_size")}, NAME)
    finally:
        jclip.CLIP_CONFIGS.clear()
        jclip.CLIP_CONFIGS.update(cfgs)


def tclip_import(sd):
    cfgs = dict(tclip.CLIP_CONFIGS)
    tclip.CLIP_CONFIGS[NAME] = tclip.CLIPConfig(**KW)
    try:
        return tclip.import_clip_torch_state({k: torch.from_numpy(np.asarray(v))
                                              for k, v in sd.items()}, NAME)
    finally:
        tclip.CLIP_CONFIGS.clear()
        tclip.CLIP_CONFIGS.update(cfgs)


def inputs(seed=1):
    rng = np.random.default_rng(seed)
    res = KW["image_resolution"]
    pixels = rng.standard_normal((B, res, res, 3)).astype(np.float32)
    tokens = rng.integers(1, KW["vocab_size"] - 1, (B, KW["context_length"])).astype(np.int32)
    tokens[np.arange(B), [3, 11, 6]] = KW["vocab_size"] - 1  # EOT: each row's highest id
    return pixels, tokens


def _close(got, want, tol=1e-5):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=tol, atol=tol)


def test_importers_agree_and_carry_across(state):
    _, variables, tstate = state
    via_flax = params_from_flax(variables)
    assert via_flax.keys() == tstate.keys()
    for k in tstate:
        assert torch.equal(via_flax[k], tstate[k]), k
    model = tclip.CLIPModel(tclip.CLIP_CONFIGS[NAME], device="cpu")
    model.load_state_dict(tstate, strict=True)
    back = flax_from_params(model)
    for path, leaf in jax.tree_util.tree_leaves_with_path(variables["params"]):
        node = back
        for p in path:
            node = node[p.key]
        np.testing.assert_array_equal(node, leaf)


def test_towers_match_jax(state):
    """The image embedding, the token grid and the causal text tower's embedding."""
    _, variables, tstate = state
    jmod = jclip.CLIPModel(jclip.CLIP_CONFIGS[NAME])
    model = tclip.CLIPModel(tclip.CLIP_CONFIGS[NAME], device="cpu")
    model.load_state_dict(tstate, strict=True)
    pixels, tokens = inputs()

    @jax.jit
    def run(v, px, tok):
        img = jmod.apply(v, px, method=jclip.CLIPModel.encode_image)
        grid = jmod.apply(v, px, return_grid=True, method=jclip.CLIPModel.encode_image)
        return img, grid, jmod.apply(v, tok, method=jclip.CLIPModel.encode_text)

    img, grid, txt = run(variables, pixels, tokens)
    with torch.no_grad():
        px, tok = torch.from_numpy(pixels), torch.from_numpy(tokens)
        _close(model.encode_image(px), img)
        got_grid = model.encode_image(px, return_grid=True)
        assert got_grid.shape == (B, 4, KW["vision_width"]) and got_grid.dtype == torch.float32
        _close(got_grid, grid)
        _close(model.encode_text(tok), txt)
        # the contiguous thirds of in_proj: read as Point-E's interleaved split, they differ
        blk = model.text.block_0.attn
        blk._panels = tclip._Panels(blk.heads, 3, [(KW["text_width"] // blk.heads) ** -0.5,
                                                   None, None], interleaved=True)
        assert (model.encode_text(tok) - torch.from_numpy(np.array(txt))).abs().max() > 1e-3


def test_image_clip_wrapper_matches_jax(state):
    sd, variables, tstate = state
    jw = jclip.ImageCLIP(variables, NAME)
    tw = tclip.ImageCLIP(tstate, NAME, device="cpu")
    pixels, tokens = inputs(2)
    _close(tw.embed_images(pixels), jw.embed_images(pixels))
    _close(tw.embed_images_grid(pixels), jw.embed_images_grid(pixels))
    _close(tw.embed_text(tokens), jw.embed_text(tokens))
    rng = np.random.default_rng(3)
    images = [rng.integers(0, 256, (40, 50, 3), dtype=np.uint8), None,
              rng.integers(0, 256, (33, 32), dtype=np.uint8), None]
    embs = [None, None, None, rng.standard_normal(KW["embed_dim"]).astype(np.float32)]
    got = tw(4, images=images, embeddings=embs)
    _close(got, jw(4, images=images, embeddings=embs))
    assert not got[1].any()
    with pytest.raises(RuntimeError):
        tw.embed_text(["no tokenizer"])


@pytest.mark.parametrize("shape", [(224, 224, 3), (300, 200, 3), (97, 451, 3), (64, 80)])
def test_preprocess_image_matches_jax(shape):
    img = np.random.default_rng(sum(shape)).integers(0, 256, shape, dtype=np.uint8)
    for res in (224, 32):
        got = tclip.preprocess_image(img, res)
        np.testing.assert_array_equal(got, jclip.preprocess_image(img, res))
        assert got.shape == (res, res, 3) and got.dtype == np.float32


@pytest.fixture(scope="module")
def merges_file(tmp_path_factory):
    """A synthetic merges file: a header, then merges that build words in several steps."""
    path = tmp_path_factory.mktemp("bpe") / "merges.txt"
    merges = ["t h", "th e</w>", "a n", "an d</w>", "r e", "re d</w>", "m o", "mo t",
              "mot o", "c y", "cy c", "cyc l", "cycl e</w>", "é t", "i n", "in g</w>",
              "' s</w>", "1 2"]
    path.write_text("#version: test\n" + "\n".join(merges) + "\n")
    return str(path)


PROMPTS = ["a red motorcycle", "The  THE the's motocycle!!", "naïve été 12 3½ <|endoftext|>x",
           "don't stop--  ringing &amp; singing", "", "日本語 テキスト\tand\n tabs"]


@pytest.mark.parametrize("use_native", [False, True], ids=["python", "native"])
def test_tokenizer_matches_jax(merges_file, use_native):
    tok = TTokenizer(merges_file, use_native=use_native)
    assert (tok._native is not None) == (use_native and tbpe.native_available())
    want = JTokenizer(merges_file, use_native=False)
    for text in PROMPTS:
        assert tok.encode(text) == want.encode(text), text
        assert tok.decode(tok.encode(text)) == want.decode(want.encode(text))
    np.testing.assert_array_equal(tok(PROMPTS, context_length=8), want(PROMPTS, context_length=8))
    np.testing.assert_array_equal(tok(PROMPTS), want(PROMPTS))
    with pytest.raises(RuntimeError):
        tok(PROMPTS[1], context_length=4, truncate=False)


def test_word_scanner_matches_the_word_pattern(merges_file):
    """The port's scanner of CLIP's word pattern against the ``regex`` pattern the JAX
    tokenizer compiles, on random strings of letters, digits, punctuation, marks, spaces,
    the two special tokens and the contractions in both cases."""
    pattern = JTokenizer(merges_file, use_native=False)._pat
    rng = np.random.default_rng(5)
    alphabet = list("abcXYZ 12'<|>!?.,-_\u00e9\u00fc\u65e5\u672c\u0663\u00bd\u0301\t") + [
        "<|endoftext|>", "<|startoftext|>", "'S", "'ll", "'re", "'VE", "'d", "'M", "'t"]
    for _ in range(3000):
        text = "".join(rng.choice(alphabet, rng.integers(0, 24)))
        assert tbpe._findall_words(text) == pattern.findall(text), repr(text)


def test_native_merge_loop_is_built_from_the_source(merges_file):
    """The native path builds ``native/bpe_tokenizer.cpp`` into ``build/`` and never loads
    the committed library."""
    if not tbpe.native_available():
        pytest.skip("no host C++ compiler on this machine")
    tok = TTokenizer(merges_file)
    assert tok._native is not None
    assert tbpe.LIBRARY.exists() and tbpe.LIBRARY.parent.name == "pcdiff_torch"
    assert tok._native.lib._name == str(tbpe.LIBRARY)

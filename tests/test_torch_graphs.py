"""The decode block behind static inputs (``repro_torch.train.graphs``) on
the CPU, where it runs eager: the packed inputs and outputs, the launch
accounting that graph replays use, and what makes the graphs be captured
again.  Capture and replay themselves need the card
(``tests/test_torch_cuda.py``)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_parity import contexts, smoke_params  # noqa: E402

from repro_torch.kernels import _cuda  # noqa: E402
from repro_torch.kernels.prng import PRNGKey  # noqa: E402
from repro_torch.train import graphs  # noqa: E402
from repro_torch.train.step import (build_decode_loop,  # noqa: E402
                                    build_spec_decode_loop)


def test_recorded_launches_count_once_per_replay():
    """What a capture counted leaves the counts as they were; each replay
    adds it once; a capture that raises leaves them alone too."""
    _cuda.reset_launch_counts()
    _cuda.LAUNCHES["qmatmul"] += 2
    with _cuda.recorded_launches() as rec:
        _cuda.LAUNCHES["qmatmul"] += 126
        _cuda.LAUNCHES["quantize_rows"] += 126
    assert _cuda.launch_counts()["qmatmul"] == 2
    assert rec["qmatmul"] == 126 and rec["quantize_rows"] == 126
    assert rec["flash_attention"] == 0
    for _ in range(3):
        _cuda.add_launches(rec)
    assert _cuda.launch_counts()["qmatmul"] == 2 + 3 * 126
    with pytest.raises(RuntimeError):
        with _cuda.recorded_launches():
            _cuda.LAUNCHES["qmatmul"] += 1
            raise RuntimeError("capture failed")
    assert _cuda.launch_counts()["qmatmul"] == 2 + 3 * 126
    _cuda.reset_launch_counts()


def test_decode_blocks_refuse_graphs_off_the_card():
    cfg, _, _ = smoke_params("none")
    _, tctx = contexts("none")
    with pytest.raises(ValueError, match="CUDA graphs"):
        graphs.DecodeBlocks(cfg, tctx, 2, "cpu", graphs=True)


@pytest.mark.parametrize("sampled", [False, True])
def test_decode_blocks_equal_the_loop(sampled):
    """The packed buffer's views feed the loop exactly what the loop takes
    directly (temperatures as float32 bits, the key, the step offset,
    EOS), and the packed outputs unpack to its outputs."""
    from repro_torch.models import api
    cfg, _, tp = smoke_params("none")
    _, tctx = contexts("none")
    b, steps, max_len = 3, 3, 16
    tokens = np.array([[5], [7], [11]], np.int32)
    pos = np.array([4, 2, 6], np.int32)
    live = np.array([True, False, True])
    stop = np.array([9, 16, 8], np.int32)
    temp = np.array([0.8, 0.0, 1.7], np.float32)
    top_k = np.array([0, 0, 4], np.int32)
    step0, eos = 13, 9

    def cache():
        c = api.init_cache_fn(cfg, b, max_len, torch.float32, "cpu")
        for leaf in (c["dense"]["k"], c["dense"]["v"]):
            leaf.copy_(torch.randn(leaf.shape,
                                   generator=torch.Generator().manual_seed(0)))
        return c

    key = PRNGKey(3) if sampled else None
    want = build_decode_loop(cfg, tctx, steps)(
        tp, cache(), torch.from_numpy(tokens), torch.from_numpy(pos),
        torch.from_numpy(live), torch.from_numpy(stop),
        {"temperature": torch.from_numpy(temp),
         "top_k": torch.from_numpy(top_k)}, key, step0, eos)
    blocks = graphs.DecodeBlocks(cfg, tctx, b, "cpu", graphs=False)
    state = blocks.pack(tokens, pos, live, stop, temp, top_k, step0, eos)
    got = blocks.unpack(blocks(tp, cache(), state, key, steps), steps)
    _, w_tok, w_pos, w_live, w_block, w_block_live, w_fault = want
    for g, w in zip(got, (w_block, w_block_live, w_tok, w_pos, w_live,
                          w_fault)):
        np.testing.assert_array_equal(g, w.numpy())
    assert blocks.captures == 0


@pytest.mark.parametrize("drafter", ["ngram", "model"])
@pytest.mark.parametrize("sampled", [False, True])
def test_spec_blocks_equal_the_loop(sampled, drafter):
    """A speculative block through the packed buffer (the drafting history
    in, the accepted counts and the history out; the model drafter's
    params and cache beside it) equals ``build_spec_decode_loop``'s loop
    called directly."""
    from repro_torch.models import api
    cfg, _, tp = smoke_params("none")
    _, tctx = contexts("none")
    b, rounds, k, max_len = 3, 2, 3, 24
    hist_len = max_len + k + 2
    rs = np.random.RandomState(0)
    tokens = np.array([[5], [7], [11]], np.int32)
    pos = np.array([6, 2, 9], np.int32)
    live = np.array([True, False, True])
    stop = np.array([14, 24, 12], np.int32)
    temp = np.array([0.8, 0.0, 1.7], np.float32)
    top_k = np.array([0, 0, 4], np.int32)
    hist = np.zeros((b, hist_len), np.int32)
    hist[:, :10] = rs.randint(0, 5, (b, 10))       # repeats: ngram matches
    step0, eos = 13, 9

    def cache():
        c = api.init_cache_fn(cfg, b, max_len + k + 2, torch.float32, "cpu")
        for leaf in (c["dense"]["k"], c["dense"]["v"]):
            leaf.copy_(torch.randn(leaf.shape,
                                   generator=torch.Generator().manual_seed(0)))
        return c

    key = PRNGKey(3) if sampled else None
    spec = dict(k=k, drafter=drafter, ngram=2)
    aux = (lambda: (tp, cache())) if drafter == "model" else (
        lambda: (torch.from_numpy(hist.copy()),))
    if drafter == "model":
        spec.update(draft_cfg=cfg, draft_ctx=tctx)
    want = build_spec_decode_loop(cfg, tctx, rounds, **spec)(
        tp, cache(), torch.from_numpy(tokens), torch.from_numpy(pos),
        torch.from_numpy(live), torch.from_numpy(stop),
        {"temperature": torch.from_numpy(temp),
         "top_k": torch.from_numpy(top_k)}, key, step0, eos, *aux())
    blocks = graphs.DecodeBlocks(cfg, tctx, b, "cpu", graphs=False,
                                 spec=dict(spec, hist_len=hist_len))
    assert blocks.hist_len == (0 if drafter == "model" else hist_len)
    state = blocks.pack(tokens, pos, live, stop, temp, top_k, step0, eos,
                        hist=hist)
    got = blocks.unpack(blocks(tp, cache(), state, key, rounds,
                               draft=aux() if drafter == "model" else None),
                        rounds)
    (_, w_tok, w_pos, w_live, w_hist, w_block, w_block_live, w_acc,
     w_fault) = want
    assert got[0].shape == (rounds * (k + 1), b)
    for g, w in zip(got[:7], (w_block, w_block_live, w_tok, w_pos, w_live,
                              w_fault, w_acc)):
        np.testing.assert_array_equal(g, w.numpy())
    if drafter == "model":
        assert got[7] is None
    else:
        np.testing.assert_array_equal(got[7], w_hist.numpy())
        assert (got[7] != hist).any()            # the rounds committed
    assert w_acc.sum() > 0 and blocks.captures == 0


def test_addresses_follow_the_tensors():
    """The graphs' owner key: the same trees give the same key; a replaced
    leaf (or QTensor payload) changes it."""
    from repro_torch.core.qtypes import FixedPointType, QTensor
    q = QTensor(torch.zeros(4, dtype=torch.int8), torch.ones(1),
                FixedPointType(8, 4))
    tree = {"a": torch.zeros(3), "b": {"w": q}}
    key = graphs._addresses(tree)
    assert graphs._addresses(tree) == key and len(key) == 3
    # a draft model's (params, cache) pair counts too
    assert graphs._addresses((tree, {"c": torch.zeros(2)}))[:3] == key
    assert len(graphs._addresses((tree, {"c": torch.zeros(2)}))) == 4
    tree["b"]["w"] = QTensor(torch.zeros(4, dtype=torch.int8), q.scale,
                             q.qtype)
    assert graphs._addresses(tree) != key

"""The graph round (``make_graph_sampler``, ``make_jit_sampler``'s
counterpart) on the CPU, where no graph can be captured: its step body,
``RoundBuffers.step``, runs uncaptured.

- Driven ceil(W / k) times with its device step counter, the body gives
  ``make_scan_sampler``'s tokens bit for bit from the same generator seed,
  and leaves the generator where the loop leaves it: k = 1, 2 and 3,
  ``rows=``, -1 pads beside a position-0 write, buffers reused by a round
  of another width, a test-size denoiser with its conditioning.
- Against JAX's ``make_scan_sampler``, the pattern of
  tests/test_torch_sampling_variants.py: logits peaked by 1e4 at one token
  that depends on the whole current grid make the draws independent of the
  noise, so both must give the same tokens.
- ``make_graph_sampler`` raises on a CPU tensor; ``make_model_sampler``
  gives a CPU model the eager loop.
- One ``cuda``-marked test holds graph rounds against the eager loop on a
  card (the same tokens, generator offset and launch counts, a capturing
  round and a replayed one); it skips here. It needs no JAX, so on a card:
  ``python -m pytest --noconftest tests/test_torch_graph_sampler.py -m cuda``.
"""
import numpy as np
import pytest
import torch

from hudiff_tpu_torch import constants as C
from hudiff_tpu_torch.models.denoiser import AntiTFNet, DenoiserConfig
from hudiff_tpu_torch.sampling import sampler as S

L_TOY = 30


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _toy_logits(seed, B, L=L_TOY):
    base = torch.randn(B, L, C.N_TOKENS, generator=torch.Generator().manual_seed(seed)) * 3

    def apply_fn(t, *cond):
        # depends on the current grid, so an out-of-order write would show
        return base + 0.05 * (t.float().sum(dim=1, keepdim=True) % 7)[..., None]

    return apply_fn


def _toy_case(seed, counts, pad_to, L=L_TOY):
    rs = np.random.RandomState(seed)
    tokens = torch.from_numpy(rs.randint(0, 22, (len(counts), L))).long()
    order = torch.from_numpy(S.build_order_rows(
        [rs.choice(L, n, replace=False) for n in counts], rng=seed + 1, pad_to=pad_to)).long()
    return tokens, order


def _body_round(buffers, tokens, order, gen, cond=()):
    """What a graph round does, uncaptured: load, ceil(W / k) steps, finish."""
    for _ in range(buffers.load(tokens, order, gen, cond)):
        buffers.step()
    return buffers.finish(gen)


def _both(apply_fn, tokens, order, k, seed, rows=None, cond=()):
    g_scan, g_body = torch.Generator().manual_seed(seed), torch.Generator().manual_seed(seed)
    ref = S.make_scan_sampler(apply_fn, positions_per_step=k)(tokens, order, g_scan, *cond,
                                                              rows=rows)
    buffers = S.RoundBuffers(apply_fn, k, tokens, cond, order.shape[1], rows)
    out = _body_round(buffers, tokens, order, g_body, cond)
    return out, ref, g_body, g_scan


@pytest.mark.parametrize('rows', [None, (2, 9)])
@pytest.mark.parametrize('k', [1, 2, 3])
def test_step_body_matches_the_scan_sampler(k, rows):
    tokens, order = _toy_case(0, (10, 7, 0, 13, 1), pad_to=13)
    out, ref, g_body, g_scan = _both(_toy_logits(1, 5), tokens, order, k, seed=4, rows=rows)
    assert torch.equal(out, ref)
    assert torch.equal(g_body.get_state(), g_scan.get_state())   # the generator advanced alike
    assert torch.equal(out[2], tokens[2]) and not torch.equal(out, tokens)


@pytest.mark.parametrize('row', [[0, -1], [-1, 0], [5, 0, -1], [-1, -1, 0, 9]])
@pytest.mark.parametrize('k', [1, 2, 3])
def test_padded_slot_beside_a_position_0_write(row, k):
    """A -1 slot gathers position 0 and writes column L: it must not undo a
    real write to position 0 in the same step."""
    tokens = torch.full((2, L_TOY), 3, dtype=torch.long)
    order = torch.tensor([row, [-1] * len(row)])
    out, ref, _, _ = _both(_toy_logits(2, 2), tokens, order, k, seed=7)
    assert torch.equal(out, ref)
    assert (out[1] == 3).all()


def test_buffers_reused_by_rounds_of_other_widths():
    """A graph's buffers serve every later round of their key: a narrower
    order leaves no column of the wider one behind."""
    apply_fn = _toy_logits(3, 4)
    tokens, wide = _toy_case(1, (12, 9, 4, 12), pad_to=12)
    _, narrow = _toy_case(2, (5, 3, 0, 5), pad_to=5)
    buffers = S.RoundBuffers(apply_fn, 2, tokens, (), wide.shape[1])
    assert buffers.width >= L_TOY
    for order, seed in ((wide, 0), (narrow, 1), (wide, 2)):
        got = _body_round(buffers, tokens, order, torch.Generator().manual_seed(seed))
        ref = S.make_scan_sampler(apply_fn, positions_per_step=2)(
            tokens, order, torch.Generator().manual_seed(seed))
        assert torch.equal(got, ref)


@pytest.mark.parametrize('k', [1, 2])
def test_step_body_on_a_test_size_denoiser(k):
    """The body as the humanizers' graph captures it: a bf16 test-size
    AntiTFNet, its region and chain conditioning copied into the buffers."""
    torch.manual_seed(0)
    model = S.cast_params_once(AntiTFNet(DenoiserConfig().test_size(),
                                         dtype=torch.bfloat16).eval())
    rs = np.random.RandomState(5)
    B = 3
    tokens = torch.from_numpy(rs.randint(0, 22, (B, C.PAIR_LEN))).long()
    order = torch.from_numpy(S.build_order_rows(
        [rs.choice(C.PAIR_LEN, n, replace=False) for n in (6, 3, 5)], rng=6, pad_to=6)).long()
    region = torch.from_numpy(np.tile(np.concatenate(
        [C.HEAVY_REGION_INDEX, C.LIGHT_REGION_INDEX]), (B, 1))).long()
    chain = torch.tensor([[0, 1], [0, 2], [0, 1]])
    with torch.inference_mode():
        out, ref, _, _ = _both(model, tokens, order, k, seed=8, cond=(region, chain))
    assert torch.equal(out, ref)


def _jax_peaked(t, *cond):
    import jax
    import jax.numpy as jnp
    tgt = (t.sum(axis=1, keepdims=True) + jnp.arange(t.shape[1])) % 22
    return 1e4 * jax.nn.one_hot(tgt, C.N_TOKENS)


def _torch_peaked(t, *cond):
    tgt = (t.sum(dim=1, keepdim=True) + torch.arange(t.shape[1])) % 22
    return 1e4 * torch.nn.functional.one_hot(tgt, C.N_TOKENS).float()


@pytest.mark.parametrize('k', [1, 2, 3])
@pytest.mark.parametrize('seed', [0, 1])
def test_step_body_matches_jax_when_logits_are_peaked(k, seed):
    import jax
    import jax.numpy as jnp

    from hudiff_tpu.sampling import sampler as JS
    tokens, order = _toy_case(seed, (10, 7, 0, 13, 1), pad_to=13)
    ref = np.asarray(JS.make_scan_sampler(_jax_peaked, positions_per_step=k)(
        jnp.asarray(tokens.numpy().astype(np.int32)), jnp.asarray(order.numpy().astype(np.int32)),
        jax.random.PRNGKey(3)))
    buffers = S.RoundBuffers(_torch_peaked, k, tokens, (), order.shape[1])
    out = _body_round(buffers, tokens, order, torch.Generator().manual_seed(5)).numpy()
    np.testing.assert_array_equal(out, ref)
    assert (out[2] == tokens[2].numpy()).all() and (out != tokens.numpy()).any()


def test_graph_sampler_refuses_cpu_tensors():
    tokens, order = _toy_case(0, (3, 2), pad_to=3)
    with pytest.raises(ValueError, match='CUDA graph'):
        S.make_graph_sampler(_toy_logits(0, 2))(tokens, order, torch.Generator())


def test_model_sampler_gives_a_cpu_model_the_eager_loop():
    torch.manual_seed(0)
    model = AntiTFNet(DenoiserConfig().test_size())
    run = S.make_model_sampler(model)
    assert not isinstance(run, S.GraphSampler)
    rs = np.random.RandomState(1)
    tokens = torch.from_numpy(rs.randint(0, 22, (2, C.PAIR_LEN))).long()
    order = torch.from_numpy(S.build_order_rows(
        [rs.choice(C.PAIR_LEN, 3, replace=False)] * 2, rng=2, pad_to=3)).long()
    cond = (torch.from_numpy(np.tile(np.concatenate(
        [C.HEAVY_REGION_INDEX, C.LIGHT_REGION_INDEX]), (2, 1))).long(),
        torch.tensor([[0, 1], [0, 2]]))
    got = run(tokens, order, torch.Generator().manual_seed(3), *cond)
    ref = S.make_scan_sampler(model)(tokens, order, torch.Generator().manual_seed(3), *cond)
    assert torch.equal(got, ref)


def test_model_sampler_gives_a_model_without_parameters_the_eager_loop():
    class Peaked(torch.nn.Module):
        def forward(self, t, *cond):
            return _torch_peaked(t)

    tokens, order = _toy_case(3, (4, 2), pad_to=4)
    run = S.make_model_sampler(Peaked())
    assert not isinstance(run, S.GraphSampler)
    ref = S.make_scan_sampler(_torch_peaked)(tokens, order, torch.Generator())
    assert torch.equal(run(tokens, order, torch.Generator()), ref)


@pytest.mark.cuda
def test_graph_rounds_match_the_eager_loop_on_a_card():
    """Test-size bf16 AntiTFNet on the card, B = 4 rows with -1 pads: a
    capturing round and a replayed one from make_graph_sampler give the
    eager loop's tokens from the same generator state, leave the generator
    at the same offset and count the same kernel launches (10 / 72 a
    forward is the full width's; here 2 K1 and 3 x 6 K2 a forward); a key
    of another batch captures its own graph."""
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU (a CUDA graph has no CPU mode)')
    from hudiff_tpu_torch.ops import fused_attention as FA
    from hudiff_tpu_torch.ops import fused_bytenet as FB
    dev = torch.device('cuda')
    torch.manual_seed(0)
    model = S.cast_params_once(AntiTFNet(DenoiserConfig().test_size(), dtype=torch.bfloat16,
                                         device=dev).eval())
    graph, eager = S.make_graph_sampler(model), S.make_scan_sampler(model)
    rs = np.random.RandomState(2)
    for B in (4, 2):
        tokens = torch.from_numpy(rs.randint(0, 22, (B, C.PAIR_LEN))).long().to(dev)
        order = torch.from_numpy(S.build_order_rows(
            [rs.choice(C.PAIR_LEN, n, replace=False) for n in (15, 9, 0, 4)[:B]],
            rng=3, pad_to=15)).long().to(dev)
        cond = (torch.from_numpy(np.tile(np.concatenate(
            [C.HEAVY_REGION_INDEX, C.LIGHT_REGION_INDEX]), (B, 1))).long().to(dev),
            torch.tensor([[0, 1], [0, 2]] * (B // 2), device=dev))
        for seed in (0, 1):   # the capturing round, then a replayed one
            outs, offsets, counts = [], [], []
            for run in (eager, graph):
                gen = torch.Generator(device=dev).manual_seed(seed)
                k1, k2 = FA.launches, FB.launches
                outs.append(run(tokens, order, gen, *cond))
                torch.cuda.synchronize()
                offsets.append(gen.get_offset())
                counts.append((FA.launches - k1, FB.launches - k2))
            assert torch.equal(outs[0], outs[1])
            assert offsets[0] == offsets[1]
            assert counts[0] == counts[1] == (2 * 15, 3 * 6 * 15)
    assert len(graph.rounds) == 2

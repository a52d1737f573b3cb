"""``matmul_plan``, the matmul wrapper's choice of CUDA path, on the CPU:
every matmul shape the served Programs hand the kernel (smollm-360m,
zamba2-7b and rwkv6-7b admissions, chunks and decode ticks at 8 slots
and max_len 512; the alexnet-owt and resnet18 FC layers at batch 8) maps
to its path, split-K slices partition K exactly, every served skinny
shape launches at least one CTA per SM, and the paths' alignment rules
send the rest to simt.  B read transposed (a tied head's (N, K)
embedding) takes skinny or wgmma at any N, never simt, and a torch
emulation of those paths' operand order and stores at N = 1 mod 8 holds
the product to the plain version with every store aligned and every
output element written once.  The dispatch refusing CPU tensors is
checked beside it."""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import CNN_REGISTRY, get_config  # noqa: E402
from repro_torch.kernels import matmul  # noqa: E402
from repro_torch.kernels.matmul.kernel import (  # noqa: E402
    SKINNY_BN, SM_COUNT, WGMMA_TILE, matmul_cuda, matmul_plain, matmul_plan)
from repro_torch.models import cnn, param_defs, transformer  # noqa: E402

SLOTS, MAX_LEN = 8, 512
LM_ARCHS = ("smollm-360m", "zamba2-7b", "rwkv6-7b")


def _weight_shape(defs, key):
    path, _, idx = key.partition(":")
    d = defs
    for part in path.split("/"):
        d = d[part]
    return tuple(d.shape[1:] if idx else d.shape)


def _lm_shapes(arch):
    """{(M, K, N)} of the pair's matmul ops: M = max_len in an admission
    (one prompt padded to max_len), slots in a decode tick."""
    cfg = get_config(arch)
    pair = transformer.compile_program_pair(cfg, slots=SLOTS,
                                            max_len=MAX_LEN)
    defs = param_defs(cfg)
    out = {}
    for kind, prog, M in (("admission", pair.prefill, MAX_LEN),
                          ("tick", pair.decode, SLOTS)):
        out[kind] = sorted({(M,) + _weight_shape(defs, op.param_key)
                            for op in prog.ops if op.kernel == "matmul"})
    return out


def _served():
    """(label, M, K, N, dtype, path) of every served matmul shape."""
    cases = []
    for arch in LM_ARCHS:
        shapes = _lm_shapes(arch)
        for M, K, N in shapes["admission"]:
            cases.append((f"{arch}-admission", M, K, N, torch.bfloat16,
                          "wgmma"))
            # A chunk call runs the prefill Program on (B, max_len) rows
            # for B in-flight admissions.
            cases.append((f"{arch}-chunk", 3 * M, K, N, torch.bfloat16,
                          "wgmma"))
        for M, K, N in shapes["tick"]:
            cases.append((f"{arch}-tick", M, K, N, torch.bfloat16,
                          "skinny"))
    for arch in ("alexnet-owt", "resnet18"):
        cfg = CNN_REGISTRY[arch]
        defs = cnn.param_defs(cfg)
        for op in cnn.compile_program(cfg, batch=SLOTS).ops:
            if op.kernel == "matmul":
                K, N = defs[op.param_key]["w"].shape
                cases.append((f"{arch}-{op.name}", SLOTS, K, N,
                              torch.float32, "skinny"))
    return cases


SERVED = _served()
IDS = [f"{c[0]}-{c[1]}x{c[2]}x{c[3]}" for c in SERVED]
SKINNY = [c for c in SERVED if c[5] == "skinny"]
SKINNY_IDS = [i for i, c in zip(IDS, SERVED) if c[5] == "skinny"]


def test_the_served_shapes_are_the_ones_phase_4_times():
    shapes = {c[1:4] for c in SERVED}
    for shape in ((8, 960, 320), (8, 960, 49152), (512, 3584, 32000),
                  (8, 14336, 3584), (512, 960, 2560), (8, 9216, 4096),
                  (8, 512, 1000), (8, 4096, 65536)):
        assert shape in shapes


@pytest.mark.parametrize("case", SERVED, ids=IDS)
def test_each_served_shape_takes_its_path(case):
    _, M, K, N, dtype, path = case
    plan = matmul_plan(M, K, N, dtype)
    assert plan.path == path
    if path == "wgmma":
        assert plan.tile == (128, 128, 64) and plan.splits == 1
        assert plan.grid == (-(-M // 128), -(-N // 128), 1)


@pytest.mark.parametrize("case", SKINNY, ids=SKINNY_IDS)
def test_split_k_slices_partition_k(case):
    _, M, K, N, dtype, _ = case
    plan = matmul_plan(M, K, N, dtype)
    slices = plan.k_slices(K)
    assert len(slices) == plan.splits == plan.grid[2]
    assert slices[0][0] == 0 and slices[-1][1] == K
    for (b0, e0), (b1, _) in zip(slices, slices[1:]):
        assert e0 == b1
    assert all(0 < e - b <= plan.kchunk for b, e in slices)
    assert plan.kchunk % 32 == 0


@pytest.mark.parametrize("case", SKINNY, ids=SKINNY_IDS)
def test_served_skinny_shapes_fill_every_sm(case):
    _, M, K, N, dtype, _ = case
    plan = matmul_plan(M, K, N, dtype)
    assert plan.ctas >= SM_COUNT
    assert plan.grid[1] == -(-N // 64)
    assert plan.grid[0] * plan.tile[0] >= M


def test_decode_projection_goes_from_10_ctas_to_hundreds():
    plan = matmul_plan(8, 960, 320, torch.bfloat16)
    assert plan.path == "skinny" and plan.ctas >= 132 and plan.splits > 1


@pytest.mark.parametrize("shape,dtype,path", [
    ((37, 300, 70), torch.bfloat16, "simt"),     # K % 8, N % 8
    ((37, 300, 70), torch.float32, "simt"),      # N % 4
    ((8, 960, 70), torch.bfloat16, "simt"),      # N % 8
    ((512, 300, 960), torch.bfloat16, "simt"),   # K % 8
    ((512, 960, 964), torch.bfloat16, "simt"),   # N % 8
    ((512, 960, 960), torch.float32, "simt"),    # f32 at M > 64
    ((65, 960, 960), torch.float32, "simt"),
    ((64, 300, 960), torch.float32, "skinny"),   # K % 4 == 0
    ((64, 960, 960), torch.bfloat16, "skinny"),
    ((65, 960, 960), torch.bfloat16, "wgmma"),
    ((1, 14336, 320), torch.bfloat16, "skinny"),
], ids=str)
def test_paths_by_type_and_alignment(shape, dtype, path):
    assert matmul_plan(*shape, dtype).path == path


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_unaligned_operands_take_the_simt_path(dtype):
    assert matmul_plan(8, 960, 960, dtype, aligned=False).path == "simt"
    assert matmul_plan(512, 960, 960, dtype, aligned=False).path == "simt"


def test_plan_refuses_other_types():
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        matmul_plan(8, 64, 64, torch.float16)


def test_cuda_impl_on_a_cpu_tensor_still_raises():
    a, b = torch.zeros(8, 960), torch.zeros(960, 320)
    with pytest.raises(RuntimeError, match="CUDA"):
        matmul(a, b, impl="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        matmul_cuda(a, b)
    assert set(matmul_cuda.path_launches) == {"skinny", "wgmma", "simt"}


# --- B read transposed: a tied head ---------------------------------------------
def test_whisper_tied_head_reads_b_transposed():
    """whisper-base's head (K = 512, N = 51,865, odd): skinny in a tick
    (M = 8 slots), wgmma in an admission (M = 448 rows), never simt; the
    same product with B in (K, N) order goes to simt (its rows are no
    whole 16-byte vectors)."""
    cfg = get_config("whisper-base")
    pair = transformer.compile_program_pair(cfg, slots=SLOTS, max_len=448)
    heads = [op for prog in (pair.prefill, pair.decode) for op in prog.ops
             if op.kernel == "matmul" and op.transpose_w]
    assert [op.param_key for op in heads] == ["embed", "embed"]
    K, N = cfg.d_model, cfg.vocab
    tick = matmul_plan(SLOTS, K, N, torch.bfloat16, b_transposed=True)
    admit = matmul_plan(448, K, N, torch.bfloat16, b_transposed=True)
    assert tick.path == "skinny" and tick.grid[1] == -(-N // SKINNY_BN)
    assert tick.ctas >= SM_COUNT
    assert admit.path == "wgmma"
    assert admit.grid == (-(-448 // 128), -(-N // 128), 1)
    assert matmul_plan(SLOTS, K, N, torch.bfloat16).path == "simt"
    assert matmul_plan(448, K, N, torch.bfloat16).path == "simt"


@pytest.mark.parametrize("shape,dtype,path", [
    ((8, 512, 51865), torch.float32, "simt"),    # f32: copied to (K, N)
    ((8, 300, 51865), torch.bfloat16, "simt"),   # K % 8
    ((8, 512, 7), torch.bfloat16, "skinny"),
    ((65, 512, 7), torch.bfloat16, "wgmma"),
], ids=str)
def test_b_transposed_paths_by_type_and_alignment(shape, dtype, path):
    assert matmul_plan(*shape, dtype, b_transposed=True).path == path
    assert matmul_plan(*shape, dtype, b_transposed=True,
                       aligned=False).path == "simt"


def _emulate_b_transposed(a, w, plan):
    """The skinny or wgmma path's work on the (N, K) tensor ``w`` in
    torch, tile by tile: B rows past N and K past a split's end load as
    zeros, each split's f32 partial is stored as the kernel stores it
    (column pairs (n, n + 1) from even n; paired f32 / bf16 stores only
    where N is even, single elements otherwise; the second column bounded
    by N) and the split-K merge sums the splits in order, four columns a
    thread where N % 4 == 0, else one.  Returns (out, stores): the f32
    result and every store as (buffer, flat index, elements)."""
    M, K = a.shape
    N = w.shape[0]
    af, wf = a.float(), w.float()
    bn = SKINNY_BN if plan.path == "skinny" else WGMMA_TILE[1]
    flat = torch.zeros(plan.splits * M * N)
    stores = []
    for s, (k0, k1) in enumerate(plan.k_slices(K)):
        for n0 in range(0, N, bn):
            tile = torch.zeros((bn, K))
            rows = wf[n0:min(N, n0 + bn)]
            tile[:rows.shape[0], k0:k1] = rows[:, k0:k1]
            part = af @ tile.T                         # (M, bn) f32
            for m in range(M):
                for n in range(n0, min(N, n0 + bn), 2):
                    cols = [n] + ([n + 1] if n + 1 < N else [])
                    base = s * M * N + m * N + n
                    buf = "ws" if plan.splits > 1 else "out"
                    if N % 2 == 0:
                        stores.append((buf, base, 2))
                    else:
                        stores += [(buf, base + i, 1) for i in
                                   range(len(cols))]
                    for i, c in enumerate(cols):
                        flat[base + i] = part[m, c - n0]
    if plan.splits == 1:
        return flat.reshape(M, N), stores
    total = M * N
    out = flat[:total].clone()
    for sp in range(1, plan.splits):
        out += flat[sp * total:(sp + 1) * total]
    width = 4 if N % 4 == 0 else 1
    stores += [("merge", e, width) for e in range(0, total, width)]
    return out.reshape(M, N), stores


@pytest.mark.parametrize("shape", [(8, 96, 57), (5, 1024, 129),
                                   (37, 64, 65), (130, 72, 9)], ids=str)
def test_b_transposed_emulation_matches_plain_with_aligned_stores(shape):
    """N = 1 mod 8 on skinny (one split and split-K) and wgmma: the
    emulated kernel against ``matmul_plain`` on the same bf16 operands;
    every paired store starts on a whole pair (f32x2 on 8 bytes, bf16x2
    on 4) and every output element is written exactly once a split."""
    M, K, N = shape
    assert N % 8 == 1
    gen = torch.Generator().manual_seed(M + K + N)
    a = torch.randn((M, K), generator=gen).bfloat16()
    w = (torch.randn((N, K), generator=gen) * K ** -0.5).bfloat16()
    plan = matmul_plan(M, K, N, torch.bfloat16, b_transposed=True)
    assert plan.path == ("skinny" if M <= 64 else "wgmma")
    out, stores = _emulate_b_transposed(a, w, plan)
    want = matmul_plain(a.float(), w.float(), b_transposed=True)
    torch.testing.assert_close(out, want, rtol=1e-5, atol=1e-5)
    for buf, e, width in stores:
        assert e % width == 0, (buf, e, width)
    for buf in ("out", "ws"):
        idx = sorted(i for b, e, width in stores if b == buf
                     for i in range(e, e + width))
        if idx:
            assert idx == list(range(plan.splits * M * N
                                     if buf == "ws" else M * N))
    if M <= 64 and K >= 1024:
        assert plan.splits > 1

"""The Adam kernel's wrapper on the CPU (``ops/adam_cuda.py``): the chunk
plan that cuts the leaves into the kernel's blocks, the kernel's own mapping
from a block to its elements, and the layout check that decides which leaves
the kernel may read as flat arrays.  The kernel itself is held to its plain
version on the card (``tests/test_torch_cuda.py``)."""
import pytest
import torch

from diffusion_extensions_tpu_torch.ops import adam_cuda
from diffusion_extensions_tpu_torch.ops.adam_cuda import CHUNK, MAX_LEAVES, chunk_cover, plan_chunks


def _model_sizes(kind):
    from diffusion_extensions_tpu_torch.models.planenet import PlaneNet
    from diffusion_extensions_tpu_torch.models.protnet import ProtNet

    with torch.device("meta"):
        model = (PlaneNet(dim=512, heads=4, layers=4) if kind == "planenet" else
                 ProtNet(dim=1024, heads=8, t_depth=12, c_depth=8, frame_pool=True,
                         cross_depth=2, rel_frame=True, equiv_head=True, bf16=True))
    return [p.numel() for p in model.parameters()]


SIZES = {
    "edges": [1, 3, 4095, 4097, 1_048_577, 0, 4096],
    "all empty": [0, 0, 0],
    "chunk edges": [CHUNK, CHUNK + 1, 2 * CHUNK - 1, 2 * CHUNK, 4, 0],
    "two launches": [5] * MAX_LEAVES + [0, CHUNK + 3],
    "three launches": [0] + [1] * (2 * MAX_LEAVES + 1),
}


@pytest.mark.parametrize("case", [*SIZES, "planenet-d512", "protnet-d1024-prod"])
def test_chunk_plan_covers_every_element_once(case):
    """Every element of every leaf lies in exactly one chunk of one launch,
    chunks are at most ``CHUNK`` long and never empty, a launch holds at most
    ``MAX_LEAVES`` leaves, and an empty leaf is in no launch."""
    sizes = (SIZES[case] if case in SIZES else
             _model_sizes("planenet" if case.startswith("planenet") else "protnet"))
    launches = plan_chunks(sizes)
    seen = {}
    for leaves, first in launches:
        assert 0 < len(leaves) <= MAX_LEAVES and len(first) == len(leaves) + 1
        assert first[0] == 0 and first[-1] < 2**31
        local = [sizes[i] for i in leaves]
        for leaf, start, stop in chunk_cover(local, first):
            assert 0 <= start < stop <= local[leaf] and stop - start <= CHUNK
            seen.setdefault(leaves[leaf], []).append((start, stop))
    assert sorted(seen) == [i for i, n in enumerate(sizes) if n > 0]
    for i, ranges in seen.items():
        ranges.sort()
        assert ranges[0][0] == 0 and ranges[-1][1] == sizes[i]
        assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    n_launches = -(-sum(n > 0 for n in sizes) // MAX_LEAVES)
    assert len(launches) == n_launches
    if case == "protnet-d1024-prod":
        assert (len(sizes), sum(sizes)) == (310, 163_077_652) and len(launches) == 1
    if case == "planenet-d512":
        assert (len(sizes), sum(sizes)) == (74, 12_941_060) and len(launches) == 1


def _t(shape, strides):
    return torch.empty_strided(shape, strides)


@pytest.mark.parametrize("tensor,dense", [
    (torch.zeros(4, 5), True),
    (torch.zeros(5, 4).t(), True),
    (torch.zeros(2, 3, 4, 5).to(memory_format=torch.channels_last), True),
    (torch.zeros(1, 7, 1), True),
    (_t((3, 1, 4), (4, 99, 1)), True),
    (torch.zeros(8, 8)[:, ::2], False),
    (torch.zeros(8, 8)[:4], True),
    (torch.zeros(8, 8)[:, :4], False),
    (torch.zeros(5).expand(3, 5), False),
    (_t((2, 2), (1, 1)), False),
], ids=["contiguous", "transposed", "channels last", "unit dims", "unit dim any stride",
        "strided", "leading rows", "column block", "expanded", "overlapping"])
def test_layout_check_accepts_only_dense_leaves(tensor, dense):
    """The kernel reads a leaf as a flat array, so a leaf's elements have to
    fill its memory span exactly once, in any order of its dimensions."""
    assert adam_cuda._dense(tensor) is dense


def test_cpu_tensors_take_the_plain_version():
    """On the CPU the wrapper is the plain version, bit for bit, and counts
    no launch."""
    from diffusion_extensions_tpu_torch import obs

    gen = torch.Generator().manual_seed(0)
    shapes = [(3, 5), (7,), (0,)]
    p = [torch.randn(s, generator=gen) for s in shapes]
    g = [torch.randn(s, generator=gen) for s in shapes]
    mu, nu = [torch.zeros(s) for s in shapes], [torch.zeros(s) for s in shapes]
    scalars = [torch.tensor(1e-3), torch.tensor(0.1), torch.tensor(0.001)]
    pr, mr, nr = [x.clone() for x in p], [x.clone() for x in mu], [x.clone() for x in nu]
    p0 = p[0].clone()
    kw = dict(impl="fused", b1=0.9, b2=0.999, eps=1e-8, clip=0.0)
    before = obs.counter("ops.adam.launches")
    adam_cuda.adam_update(p, g, mu, nu, *scalars, None, **kw)
    adam_cuda.adam_update_ref(pr, g, mr, nr, *scalars, None, **kw)
    assert obs.counter("ops.adam.launches") == before
    for a, b in zip(p + mu + nu, pr + mr + nr):
        assert torch.equal(a, b)
    assert not torch.equal(p[0], p0)

"""K1's coalesced batch: items read and written where they lie.

``Program.call_batch`` launches K1's batch kernel once over the items'
own tensors: program ``pid`` runs row block ``pid % blocks_per_item`` of
item ``pid // blocks_per_item``, the tail past an item's ``n`` elements
masked (read as 0, not stored), and each item gets an output tensor of
its own. On the CPU the same walk runs through its plain version
(``fused_kernel.emulate_items``, ``interpret`` mode), so these tests hold
the new addressing, not only the arithmetic:

* ragged ``n``, shared and mixed scalars, and a carried stage: every
  item bit-identical to its solo call (the solo path pads with zeros
  where the batch masks), and to the torch oracle where there is one;
* a tail that the stage bodies can see (a row maximum over negative
  values) reads exactly the zeros a solo call pads with;
* non-contiguous and misaligned items give the same results; the
  kernel's placement copies exactly those, alone (``place_items``), and
  its offset table addresses every item from item 0's pointer;
* results are separate tensors that hold only their own elements;
* a ragged mixed-scalar batch against the JAX package's ``call_batch``
  in ``interpret`` mode, within ``4·eps·(|s·x| + |b|)`` (XLA may
  contract the multiply-add into one FMA; torch eager rounds twice).

The kernel itself runs only on the card (tests/test_torch_kernels.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.kernels  # noqa: F401 — registers the JAX ISA
import repro_torch.kernels  # noqa: F401 — registers the port's c0 ISA
from repro.core import isa as jisa
from repro_torch.core import fused_kernel as fk
from repro_torch.core import isa
from repro_torch.core import program as prog_mod
from repro_torch.core.template import KernelTemplate

EPS = float(np.finfo(np.float32).eps)


def rand(n, seed=0):
    return np.random.default_rng(seed).standard_normal(n, dtype=np.float32)


@pytest.fixture
def fresh_caches():
    prog_mod.clear_dispatch_caches()
    prog_mod.reset_dispatch_stats()
    yield
    prog_mod.clear_dispatch_caches()


def _absmax_body(scalars, ins, carry, step):
    m = torch.maximum(carry, ins[0].abs().amax(dim=-1, keepdim=True))
    return (ins[0] / torch.clamp_min(m, 1e-9),), m


def _rowmax_body(scalars, ins, carry, step):
    return (ins[0] * 0 + ins[0].amax(dim=-1, keepdim=True),), carry


ABSMAX = KernelTemplate(name="absmax_batch", body=_absmax_body,
                        carry_cols=1)
ROWMAX = KernelTemplate(name="rowmax_batch", body=_rowmax_body)


@pytest.mark.parametrize("n", [1, 7, 4095, 4096, 3 * 4096 + 5, 70_001])
@pytest.mark.parametrize("mixed", [False, True])
def test_ragged_items_bit_identical_to_solo(fresh_caches, n, mixed):
    fused = isa.fuse("c0_scale", "c0_add")
    batch = [(0.25 * (k + 1) if mixed else 1.5,
              torch.from_numpy(rand(n, 2 * k)),
              torch.from_numpy(rand(n, 2 * k + 1))) for k in range(4)]
    with prog_mod.dispatch_stats_window() as w:
        got = fused.program.call_batch(batch, interpret=True)
        assert w.delta("batch_calls") == 1
        assert w.delta("batch_items") == 4
        assert w.delta("batch_mixed") == int(mixed)
    for item, out in zip(batch, got):
        assert out.shape == (n,)
        assert torch.equal(out, fused(*item, mode="interpret"))
        assert torch.equal(out, fused(*item, mode="ref"))


@pytest.mark.parametrize("shape", [(3, 1000), (17, 4097), (5, 8192)])
def test_carried_stage_in_a_batch(fresh_caches, shape):
    prog = ABSMAX.program()
    items = [(torch.from_numpy(rand(shape, k)),) for k in range(3)]
    got = prog.call_batch(items, interpret=True)
    for (x,), out in zip(items, got):
        assert out.shape == x.shape
        assert torch.equal(out, prog(x, interpret=True))


def test_masked_tail_reads_zeros_as_the_solo_padding(fresh_caches):
    # every value negative: a row that holds the tail has maximum 0 in
    # both paths, so the batch must read the tail as exactly 0
    prog = ROWMAX.program()
    n = 3 * 4096 + 5
    items = [(-torch.from_numpy(rand(n, k)).abs() - 1,) for k in range(3)]
    got = prog.call_batch(items, interpret=True)
    for (x,), out in zip(items, got):
        solo = prog(x, interpret=True)
        assert torch.equal(out, solo)
        assert float(out[-1]) == 0.0          # the last row saw the zeros


def test_non_contiguous_and_misaligned_items(fresh_caches):
    fused = isa.fuse("c0_scale", "c0_add")
    n = 3 * 4096 + 5
    big = torch.from_numpy(rand(2 * n + 2, 7))
    x_off, b_strided = big[1:n + 1], big[::2][:n]
    assert x_off.data_ptr() % 16 and not b_strided.is_contiguous()
    batch = [(0.5, torch.from_numpy(rand(n, 1)), torch.from_numpy(rand(n, 2))),
             (1.5, x_off, torch.from_numpy(rand(n, 3))),
             (2.5, torch.from_numpy(rand(n, 4)), b_strided)]
    got = fused.program.call_batch(batch, interpret=True)
    for (s, x, b), out in zip(batch, got):
        assert torch.equal(out, fused(s, x.contiguous(), b.contiguous(),
                                      mode="interpret"))


def test_placement_copies_only_what_the_kernel_cannot_read():
    n = 1000
    big = torch.from_numpy(rand(2 * n + 4, 5))
    aligned = torch.from_numpy(rand(n, 6))
    items = [[aligned, big[4:n + 4]],         # 16 bytes in: read in place
             [big[1:n + 1], big[::2][:n]]]    # 4 bytes off, strided: copied
    assert big[4:].data_ptr() % 16 == 0
    ops, copies = fk.place_items(items)
    assert copies == 2
    assert ops[0][0].data_ptr() == aligned.data_ptr()
    assert ops[0][1].data_ptr() == big[4:].data_ptr()
    for row, want in zip(ops, items):
        for t, w in zip(row, want):
            assert t.is_contiguous() and t.data_ptr() % 16 == 0
            assert torch.equal(t, w.reshape(-1))
    with pytest.raises(ValueError, match="one dtype and size"):
        fk.place_items([[aligned], [aligned[:10]]])


def test_offset_table_addresses_each_item_from_item_0():
    rows = [[torch.empty(100), torch.empty(100)] for _ in range(4)]
    table = fk.item_offsets(rows)
    assert table[0] == [0, 0]
    for row, offs in zip(rows, table):
        for slot, (t, off) in enumerate(zip(row, offs)):
            assert rows[0][slot].data_ptr() + 16 * off == t.data_ptr()


def test_results_are_separate_tensors(fresh_caches):
    fused = isa.fuse("c0_scale", "c0_add")
    n = 4096 + 3
    batch = [(1.0 + k, torch.from_numpy(rand(n, k)),
              torch.from_numpy(rand(n, k + 9))) for k in range(3)]
    got = fused.program.call_batch(batch, interpret=True)
    storages = {o.untyped_storage().data_ptr() for o in got}
    assert len(storages) == len(got)
    for out in got:
        assert out.untyped_storage().nbytes() == n * out.element_size()


def test_emulator_walks_items_by_row_block():
    # the plain version of the batch kernel against the stacked, padded
    # layout the batch used to build: the same values, item by item
    prog = isa.fuse("c0_scale", "c0_add").program
    n, br, bc = 3 * 1024 + 11, 2, 512
    items = [[torch.from_numpy(rand(n, 2 * k)),
              torch.from_numpy(rand(n, 2 * k + 1))] for k in range(3)]
    table = torch.tensor([[0.5], [1.5], [2.5]])
    bpi = -(-n // (br * bc))
    got = fk.emulate_items(prog.stages, prog._n_ext, table, items, br, bc,
                           bpi)
    stacked = []
    for slot in range(2):
        flat = torch.zeros(3, bpi * br * bc)
        for k, it in enumerate(items):
            flat[k, :n] = it[slot]
        stacked.append(flat.view(-1, bc))
    want = fk.emulate(prog.stages, prog._n_ext, table, stacked, br, bc, bpi)
    for k in range(3):
        assert torch.equal(got[k][0], want[0].view(3, -1)[k, :n])


def test_ragged_mixed_batch_matches_jax(fresh_caches):
    n = 3 * 4096 + 5
    items = [(0.25 * (k + 1), rand(n, 2 * k), rand(n, 2 * k + 1))
             for k in range(5)]
    got = isa.fuse("c0_scale", "c0_add").program.call_batch(
        [(s, torch.from_numpy(x), torch.from_numpy(b)) for s, x, b in items],
        interpret=True)
    want = jisa.fuse("c0_scale", "c0_add").program.call_batch(
        [(s, jnp.asarray(x), jnp.asarray(b)) for s, x, b in items],
        interpret=True)
    for (s, x, b), g, w in zip(items, got, want):
        bound = 4 * EPS * (abs(s) * np.abs(x) + np.abs(b))
        assert g.shape == (n,)
        assert np.all(np.abs(g.numpy() - np.asarray(w)) <= bound)


def test_batch_kernel_source():
    prog = isa.fuse("c0_scale", "c0_add", "c0_copy").program
    src = fk.kernel_source(prog.stages, prog._n_ext, batch=True)
    compile(src, "<k1 batch>", "exec")
    assert "def k1_batch_kernel(" in src and "def k1_kernel(" not in src
    loads = [ln for ln in src.splitlines() if "tl.load(X" in ln]
    stores = [ln for ln in src.splitlines() if "tl.store(O" in ln]
    assert len(loads) == prog.n_ext_vec_in
    assert len(stores) == prog.n_vec_out
    assert all("mask=mask" in ln for ln in loads + stores)
    assert src.count("tl.multiple_of(") == prog.n_ext_vec_in + prog.n_vec_out
    assert "item = pid // blocks_per_item" in src
    assert "mask = offs < n_valid if RAGGED else None" in src


def test_kernel_mode_on_cpu_raises_before_any_build(fresh_caches):
    fused = isa.fuse("c0_scale", "c0_add")
    x = torch.ones(300)
    with prog_mod.dispatch_stats_window() as w:
        with pytest.raises(RuntimeError, match="CUDA"):
            fused.program.call_batch([(1.0, x, x), (2.0, x, x)])
        assert w.delta("kernel_traces") == 0
    with pytest.raises(RuntimeError, match="CUDA"):
        fk.K1.launch_items(None, torch.empty((1, 0)), [[x], [x]], 1, 8,
                           128, 1)

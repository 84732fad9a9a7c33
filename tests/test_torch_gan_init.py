"""The port's ``init_gan_state`` against the JAX package on the CPU: both
discriminators and the generator decoder's spectral-normed res blocks (``u``
included; the in_block and the first upsampling block, the others being the
same code) as JAX draws them from the same key, leaf for leaf within
1e-6·(1+|ref|) (``prng.normal`` lies within 7.2e-7 of JAX's draw,
tests/test_torch_prng.py; the uniform draws are mostly bitwise; the rest of
the generator is tests/test_torch_init.py's first stage); every ``u`` a unit
vector, every ``u`` out of the optimizers.  Most of its ~35 s here is JAX
running its own init of the temporal disc's fixed 64–512 widths (~9 s) and
compiling it."""
import jax
import pytest
import torch

from ipoke_tpu.models import discriminators as JD
from ipoke_tpu.models import first_stage as jfs
from ipoke_tpu.nn import blocks as jblocks
from ipoke_tpu_torch.ckpt.jax_bridge import _convert, bridge_gan_params
from ipoke_tpu_torch.models import discriminators as D
from ipoke_tpu_torch.models import first_stage as pfs
from ipoke_tpu_torch.train import first_stage as tfs
from ipoke_tpu_torch.train.second_stage import float_leaves
from ipoke_tpu_torch.utils import prng
from torch_port_util import CPU, flatten, gan_specs, jit_o0, np_tree

INIT_TOL = 1e-6


def test_init_gan_state_draws_jax_nets():
    fs, ds, dt = gan_specs(pfs, D)
    jfs_spec, jds, jdt = gan_specs(jfs, JD)
    state, opts = tfs.init_gan_state(prng.prng_key(0), fs, ds, dt, device=CPU)
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(0), 3)

    kb = jax.random.split(jax.random.split(k1, 4)[2], 2 * 3 + 2)   # the decoder's keys

    @jit_o0
    def reference(k2, k3, kb):
        # the decoder's in_block and first upsampling block: the spectral norm
        # threaded through init_res_block (the other blocks are the same code)
        gen = {"in_block": jblocks.init_res_block(kb[0], 8, 16, norm="group", snorm=True),
               "blocks": [jblocks.init_res_block(kb[1], 16, 8, norm="none", upsampling=True,
                                                 snorm=True)]}
        return gen, {"ds_params": JD.init_patch_disc(k2, jds), "dt_params": JD.init_temp_disc(k3, jdt)}

    jgen, jdiscs = np_tree(reference(k2, k3, kb))
    want = bridge_gan_params(jdiscs, device=CPU)
    want["gen_params"] = {"gen": {
        "in_block": _convert(jgen["in_block"], CPU, keep_u=True),
        "blocks": [{k: _convert(v, CPU, transposed=k != "conv2", keep_u=True)
                    for k, v in jgen["blocks"][0].items()}]}}
    gen = state.gen_params["gen"]
    got = {"gen_params": {"gen": {"in_block": gen["in_block"], "blocks": gen["blocks"][:1]}},
           "ds_params": state.ds_params, "dt_params": state.dt_params}
    n_u = 0
    for k, w in flatten(want).items():
        g = flatten(got)[k].detach()
        assert g.shape == w.shape, k
        assert float(((g - w).abs() / (1 + w.abs())).max()) <= INIT_TOL, k
        if k.endswith("/u"):
            n_u += 1
            assert abs(float(torch.linalg.vector_norm(g)) - 1) < 1e-6, k
    assert flatten(got).keys() == flatten(want).keys() and n_u == 6 + 3 + 12
    assert sum(k.endswith("/u") for k in flatten(gen)) == 3 * 4   # every decoder res block
    # the optimizers run over every float leaf but u, each needing grad
    for n in tfs.NETS:
        p = getattr(state, f"{n}_params")
        leaves = float_leaves(tfs.trainable(p))
        assert len(getattr(state, f"{n}_opt")[1]["mu"]) == len(leaves)
        assert all(x.requires_grad for x in leaves)
        assert not any(v.requires_grad for k, v in flatten(p).items() if k.endswith("/u"))
    if not torch.cuda.is_available():   # no quiet fallback to the CPU
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tfs.init_gan_state(prng.prng_key(0), fs, ds, dt)

"""Nothing the benchmark loads is JAX or the JAX package; the reference
imports nothing of the program."""
from benchmark import importcheck


def test_nothing_forbidden_is_loaded():
    loaded = importcheck.loaded_modules()
    assert "diffusion_extensions_tpu_torch" in {m.split(".")[0] for m in loaded}
    assert importcheck.forbidden(loaded) == []


def test_reference_imports_neither_the_program_nor_jax():
    for path, names in importcheck.reference_imports().items():
        assert not names & {importcheck.PROGRAM, *importcheck.FORBIDDEN}, path
        assert names <= {"__future__", "math", "numpy", "torch"}, (path, names)


def test_whole_names():
    assert importcheck.forbidden(["jax", "jaxlib.xla", "flax.linen", "diffusion_extensions_tpu.ops"]) == [
        "diffusion_extensions_tpu.ops", "flax.linen", "jax", "jaxlib.xla"]
    assert importcheck.forbidden(["diffusion_extensions_tpu_torch.ops", "jaxtyping", "flaxen"]) == []

"""The port's ground rules: it imports neither jax nor the JAX package, and
its entry points run on CUDA unless the caller asks for the CPU."""

import os
import subprocess
import sys
import textwrap

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

BLOCKED_IMPORTS = textwrap.dedent("""
    import importlib, pkgutil, sys

    class Refuse:
        def find_spec(self, name, path=None, target=None):
            top = name.split(".")[0]
            if top in ("jax", "jaxlib", "spectre_tpu"):
                raise ImportError("blocked: " + name)
            return None

    sys.meta_path.insert(0, Refuse())
    import spectre_tpu_torch
    names = [m.name for m in pkgutil.walk_packages(spectre_tpu_torch.__path__,
                                                    "spectre_tpu_torch.")]
    for name in names:
        importlib.import_module(name)
    import chip_smoke
    bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "spectre_tpu")]
    assert not bad, bad
    print(len(names))
""")


def test_port_imports_nothing_of_jax_or_the_reference():
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", BLOCKED_IMPORTS], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip().splitlines()[-1]) >= 20


STAGE_TWO = ("spectre_tpu_torch.plonk.in_circuit", "spectre_tpu_torch.models.aggregation",
             "spectre_tpu_torch.builder.msm_chip", "spectre_tpu_torch.builder.transcript_chip",
             "spectre_tpu_torch.plonk.transcript")


def test_stage_two_modules_import_nothing_of_jax_or_the_reference():
    """The aggregation slice's modules, each imported alone under the same
    refusal, and its transcripts and host routine present."""
    for name in STAGE_TWO:
        prelude = BLOCKED_IMPORTS.split("\nimport spectre_tpu_torch\n")[0]
        assert "class Refuse" in prelude and "walk_packages" not in prelude
        script = prelude + textwrap.dedent(f"""
            import importlib
            mod = importlib.import_module("{name}")
            bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "spectre_tpu")]
            assert not bad, bad
        """)
        out = subprocess.run([sys.executable, "-c", script], cwd=REPO, capture_output=True,
                             text=True, timeout=300, env=dict(os.environ, PYTHONPATH=REPO))
        assert out.returncode == 0, (name, out.stderr)
    from spectre_tpu_torch.ops import kernel_lib as KL
    from spectre_tpu_torch.plonk import transcript as T
    assert {"Blake2bTranscript", "PoseidonTranscript", "KeccakTranscript"} <= set(vars(T))
    assert os.path.exists(os.path.join(KL.CSRC, KL.HOST_LIBRARIES["sigma_host"][0]))


EVM_TAIL = ("spectre_tpu_torch.prover_service", "spectre_tpu_torch.prover_service.calldata",
            "spectre_tpu_torch.evm", "spectre_tpu_torch.evm.codegen",
            "spectre_tpu_torch.evm.simulator", "spectre_tpu_torch.evm.gas",
            "spectre_tpu_torch.evm.vm", "spectre_tpu_torch.evm.solc",
            "spectre_tpu_torch.evm.solc_spectre", "spectre_tpu_torch.contracts",
            "spectre_tpu_torch.contracts.spectre", "spectre_tpu_torch.contracts.sol_gen")


def test_evm_tail_modules_import_nothing_of_jax_or_the_reference():
    """The EVM tail's modules, imported one after another under the same
    refusal with the reference's modules checked after each, and the
    package walk finds each of them."""
    prelude = BLOCKED_IMPORTS.split("\nimport spectre_tpu_torch\n")[0]
    script = prelude + textwrap.dedent(f"""
        import importlib
        for name in {EVM_TAIL!r}:
            importlib.import_module(name)
            bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "spectre_tpu")]
            assert not bad, (name, bad)
        import spectre_tpu_torch
        names = {{m.name for m in pkgutil.walk_packages(spectre_tpu_torch.__path__,
                                                       "spectre_tpu_torch.")}}
        assert set({EVM_TAIL!r}) <= names, set({EVM_TAIL!r}) - names
    """)
    out = subprocess.run([sys.executable, "-c", script], cwd=REPO, capture_output=True,
                         text=True, timeout=300, env=dict(os.environ, PYTHONPATH=REPO))
    assert out.returncode == 0, out.stderr
    from spectre_tpu_torch.evm import gen_evm_verifier
    from spectre_tpu_torch.prover_service import decode_calldata, encode_calldata
    assert callable(gen_evm_verifier) and callable(encode_calldata) and callable(decode_calldata)


ACQUISITION = ("spectre_tpu_torch.utils.health", "spectre_tpu_torch.utils.faults",
               "spectre_tpu_torch.utils.breaker", "spectre_tpu_torch.utils.profiling",
               "spectre_tpu_torch.observability", "spectre_tpu_torch.observability.metrics",
               "spectre_tpu_torch.observability.tracing", "spectre_tpu_torch.preprocessor",
               "spectre_tpu_torch.preprocessor.snappy_codec",
               "spectre_tpu_torch.preprocessor.ssz", "spectre_tpu_torch.ops.field384",
               "spectre_tpu_torch.preprocessor.step", "spectre_tpu_torch.preprocessor.rotation",
               "spectre_tpu_torch.preprocessor.beacon",
               "spectre_tpu_torch.preprocessor.spec_tests",
               "spectre_tpu_torch.gadgets.multiproof", "spectre_tpu_torch.witness.ref_fixtures",
               "spectre_tpu_torch.test_utils")


def test_acquisition_modules_import_nothing_of_jax_or_the_reference():
    """The witness-acquisition slice's modules, imported one after another
    under the same refusal with the reference's modules checked after each,
    and the package walk finds each of them."""
    prelude = BLOCKED_IMPORTS.split("\nimport spectre_tpu_torch\n")[0]
    script = prelude + textwrap.dedent(f"""
        import importlib
        for name in {ACQUISITION!r}:
            importlib.import_module(name)
            bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "spectre_tpu")]
            assert not bad, (name, bad)
        import spectre_tpu_torch
        names = {{m.name for m in pkgutil.walk_packages(spectre_tpu_torch.__path__,
                                                       "spectre_tpu_torch.")}}
        assert set({ACQUISITION!r}) <= names, set({ACQUISITION!r}) - names
    """)
    out = subprocess.run([sys.executable, "-c", script], cwd=REPO, capture_output=True,
                         text=True, timeout=300, env=dict(os.environ, PYTHONPATH=REPO))
    assert out.returncode == 0, out.stderr

NTT_MODES = ("spectre_tpu_torch.ops.field_mxu", "spectre_tpu_torch.ops.ntt",
             "spectre_tpu_torch.ops.field_ops", "spectre_tpu_torch.observability.manifest",
             "spectre_tpu_torch.observability.prom")


def test_ntt_modes_modules_import_nothing_of_jax_or_the_reference():
    """The NTT modes' and the 8-bit-limb product's modules, imported one
    after another under the same refusal with SPECTRE_FIELD_IMPL=mxu set,
    and the sources of their kernels (K7, K8) present."""
    prelude = BLOCKED_IMPORTS.split("\nimport spectre_tpu_torch\n")[0]
    script = prelude + textwrap.dedent(f"""
        import importlib
        for name in {NTT_MODES!r}:
            importlib.import_module(name)
            bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "spectre_tpu")]
            assert not bad, (name, bad)
        assert sys.modules["spectre_tpu_torch.ops.field_ops"].mxu_enabled()
    """)
    out = subprocess.run([sys.executable, "-c", script], cwd=REPO, capture_output=True,
                         text=True, timeout=300,
                         env=dict(os.environ, PYTHONPATH=REPO, SPECTRE_FIELD_IMPL="mxu"))
    assert out.returncode == 0, out.stderr
    from spectre_tpu_torch.ops import kernel_lib as KL
    for lib, kernel in (("field_mxu_kernels", "K7_mont_mul_mxu"),
                        ("ntt_matmul_kernels", "K8_ntt_dft_matmul")):
        assert os.path.exists(os.path.join(KL.CSRC, KL.LIBRARIES[lib][0]))
        assert KL.KERNELS[kernel].source.endswith(KL.LIBRARIES[lib][0])


def test_chip_smoke_refuses_without_a_gpu(tmp_path):
    """Alone in a directory, or on a machine without CUDA, the smoke exits
    non-zero and prints no result line."""
    src = os.path.join(REPO, "chip_smoke.py")
    lone = tmp_path / "chip_smoke.py"
    lone.write_text(open(src).read())
    for script, cwd in ((src, REPO), (str(lone), str(tmp_path))):
        out = subprocess.run([sys.executable, script], cwd=cwd, capture_output=True,
                             text=True, timeout=300,
                             env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
        assert out.returncode != 0
        assert '"ok"' not in out.stdout


class TestDeviceDefault:
    """Without a GPU, every entry point called without device= raises."""

    @pytest.fixture(autouse=True)
    def _no_gpu(self):
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present: the default is usable here")
        before = torch.get_num_threads()
        torch.set_num_threads(2)     # six test workers share the machine
        yield
        torch.set_num_threads(before)

    def test_backend_srs_keygen_prove_msm_raise(self):
        from spectre_tpu_torch.ops import field_ops as F
        from spectre_tpu_torch.plonk.backend import TorchBackend
        from spectre_tpu_torch.plonk.constraint_system import Assignment, CircuitConfig
        from spectre_tpu_torch.plonk.keygen import keygen
        from spectre_tpu_torch.plonk.prover import prove
        from spectre_tpu_torch.plonk.srs import SRS

        with pytest.raises(RuntimeError, match="CUDA"):
            TorchBackend()
        with pytest.raises(RuntimeError, match="CUDA"):
            SRS.unsafe_setup(4)
        cfg = CircuitConfig(k=5, num_advice=1, num_lookup_advice=1, num_fixed=1,
                            lookup_bits=3)
        srs = SRS.unsafe_setup(5, device="cpu")
        zeros = [[0] * cfg.n]
        with pytest.raises(RuntimeError, match="CUDA"):
            keygen(srs, cfg, zeros, zeros, [])
        pk = keygen(srs, cfg, zeros, zeros, [], device="cpu")
        asg = Assignment(cfg, zeros, zeros, zeros, zeros, [[]], [])
        with pytest.raises(RuntimeError, match="CUDA"):
            prove(pk, srs, asg)
        with pytest.raises(RuntimeError, match="CUDA"):
            srs.device_base()
        assert F.mont_mul(F.fr_ctx(), F.const(F.fr_ctx(), 2, "cpu"),
                          F.const(F.fr_ctx(), 3, "cpu")).device.type == "cpu"

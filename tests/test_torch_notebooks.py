"""The port's five paper-figure notebooks
(`bnn_priors_tpu_torch/experiments/notebooks/Plot_*.ipynb`): each parses
and validates, names neither JAX nor the JAX package in its code, keeps
the JAX notebook's figures in their order, and executes headlessly (nbclient,
Agg) on the CPU with its parameters cell followed by miniature sizes, the
five in one kernel.
`figures.py` imports with pandas, matplotlib and h5py blocked.
"""
import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

import pytest

nbformat = pytest.importorskip("nbformat")

REPO = Path(__file__).resolve().parent.parent
PORT_NBS = REPO / "bnn_priors_tpu_torch" / "experiments" / "notebooks"
JAX_NBS = REPO / "experiments"
ALL = ["Plot_weight_histograms", "Plot_CIFAR10_resnet",
       "Plot_MNIST_convnet_covariances", "Plot_tempering_curves",
       "Plot_temperature_diagnostics"]
ON_A_DEVICE = ("Plot_weight_histograms", "Plot_tempering_curves",
               "Plot_temperature_diagnostics")

# each notebook's miniature sizes (appended after its parameters cell) and
# its own time limit in seconds
MINIATURE = {
    "Plot_weight_histograms": ('DEVICE = "cpu"\n'
                               'DATA_KW = {"n_train": 256, "n_test": 16}\n'
                               "N_TRAIN = 256\nWIDTH = 4", 60),
    "Plot_CIFAR10_resnet": ("", 60),
    "Plot_MNIST_convnet_covariances": ("", 60),
    "Plot_tempering_curves": ('DEVICE = "cpu"\nTEMPS = [0.1, 1.0]\n'
                              "REPLICATES = 2\nWIDTH = 4\nDEPTH = 2\n"
                              "CYCLES = 1\nEPOCHS_PER_CYCLE = 2\n"
                              "N_POINTS = 128\nLOG_DIR = LOG_DIR_HERE", 60),
    "Plot_temperature_diagnostics": ('DEVICE = "cpu"\nN_TRAIN = 64\n'
                                     "WIDTH = 4\nCYCLES = 1\n"
                                     "EPOCHS_PER_CYCLE = 2\n"
                                     "WARMUP_EPOCHS = 1\nSAMPLE_EPOCHS = 1",
                                     60),
}


def _read(path):
    return nbformat.read(path, as_version=4)


def _code(nb):
    return [c.source for c in nb.cells if c.cell_type == "code"]


@pytest.mark.parametrize("name", ALL)
def test_notebook_parses_and_names_only_the_port(name):
    """valid nbformat v4; no code cell names `jax` or `bnn_priors_tpu`
    other than `bnn_priors_tpu_torch`; the root-finding cell looks for the
    port; a parameters cell comes before the compute, with DEVICE on the
    card by default where the notebook runs a model"""
    nb = _read(PORT_NBS / f"{name}.ipynb")
    nbformat.validate(nb)
    code = _code(nb)
    for src in code:
        assert not re.search(r"\bjax\b", src), src
        assert not re.search(r"bnn_priors_tpu(?!_torch)", src), src
    assert '(_p / "bnn_priors_tpu_torch").is_dir()' in code[0]
    params = [c for c in nb.cells if "parameters" in c.metadata.get("tags", [])]
    assert len(params) == 1 and params[0].source == code[1]
    if name in ON_A_DEVICE:
        assert 'DEVICE = "cuda"' in params[0].source


@pytest.mark.parametrize("name", ALL)
def test_notebook_keeps_the_jax_notebooks_figures(name):
    """the JAX notebook's title and figures: the same first heading, the
    same number of figures, and each figure's title in the same order"""
    ours, theirs = (_read(d / f"{name}.ipynb") for d in (PORT_NBS, JAX_NBS))
    heading = lambda nb: nb.cells[0].source.splitlines()[0]
    assert heading(ours) == heading(theirs)
    titles = lambda nb: re.findall(r"(?:suptitle|set_title)\((f?\"[^\"]*\")",
                                   "\n".join(_code(nb)))
    assert titles(ours) == titles(theirs)
    count = lambda nb: sum(s.count("plt.subplots(") for s in _code(nb))
    assert count(ours) == count(theirs) > 0


def _fake_sweep(root):
    "run dirs of two priors at two temperatures, as a sweep leaves them"
    for i, (prior, t, lp) in enumerate([("gaussian", 0.1, -1.0),
                                        ("gaussian", 1.0, -1.5),
                                        ("laplace", 0.1, -1.2),
                                        ("laplace", 1.0, -1.1)]):
        d = root / str(i + 1)
        d.mkdir()
        (d / "config.json").write_text(json.dumps(
            {"weight_prior": prior, "temperature": t}))
        (d / "run.json").write_text(json.dumps(
            {"status": "COMPLETED", "result": {"lp_ensemble": lp}}))
        (d / "metrics.h5").write_bytes(b"")


@pytest.fixture(scope="module")
def kernel():
    """one python3 kernel for the module's executions, started in the
    notebooks' directory with Agg and one torch thread: the imports
    (torch, matplotlib, scipy.stats) are paid once, and each notebook
    starts from an empty namespace (`%reset -f`)"""
    jupyter_client = pytest.importorskip("jupyter_client")
    pytest.importorskip("nbclient")
    km = jupyter_client.KernelManager(kernel_name="python3")
    km.start_kernel(cwd=str(PORT_NBS), env=dict(
        os.environ, MPLBACKEND="Agg", OMP_NUM_THREADS="1"))
    try:
        yield km
    finally:
        km.shutdown_kernel(now=True)


@pytest.mark.parametrize("name", ALL)
def test_notebook_executes_on_the_cpu(name, tmp_path, kernel):
    """the whole notebook headlessly on the CPU at miniature sizes, from an
    empty namespace, within its own time limit; no cell errs (nbclient
    raises), and the tempering notebook's last cell finds the sweep's run
    dirs"""
    import nbclient
    (tmp_path / "sweep").mkdir()
    _fake_sweep(tmp_path / "sweep")
    nb = _read(PORT_NBS / f"{name}.ipynb")
    sizes, limit = MINIATURE[name]
    at = next(i for i, c in enumerate(nb.cells)
              if "parameters" in c.metadata.get("tags", []))
    nb.cells.insert(at + 1, nbformat.v4.new_code_cell(
        sizes.replace("LOG_DIR_HERE", repr(str(tmp_path / "sweep")))))
    nb.cells.insert(0, nbformat.v4.new_code_cell(
        '%reset -f\nimport matplotlib.pyplot\nmatplotlib.pyplot.close("all")'
        "\ndel matplotlib"))
    t0 = time.perf_counter()
    nbclient.NotebookClient(nb, km=kernel, timeout=limit).execute()
    assert time.perf_counter() - t0 < limit
    text = json.dumps([c.get("outputs", []) for c in nb.cells])
    assert "Traceback" not in text
    if name == "Plot_tempering_curves":
        assert "no sweep logs found" not in text


def test_figures_imports_without_pandas_matplotlib_h5py():
    "figures.py (and what it imports) with the three blocked"
    code = """
import sys
for m in ("pandas", "matplotlib", "h5py"):
    sys.modules[m] = None
from bnn_priors_tpu_torch import notebook_utils
from bnn_priors_tpu_torch.experiments import figures
assert "jax" not in sys.modules and "bnn_priors_tpu" not in sys.modules
names, dfs = figures.mvt_dfs()
assert len(names) == len(dfs) > 0
assert notebook_utils.flatten({"a": {"b": 1}, "c": 2}) == {"c": 2, "a.b": 1}
assert notebook_utils.run_records(".") == []
print("ok")
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.split() == ["ok"]

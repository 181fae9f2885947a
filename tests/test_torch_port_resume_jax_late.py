"""The JAX trainer resumes the port's RL and joint phases from their
pickle ``_trainstate`` siblings (test_torch_port_resume_jax.py holds the
check and phases 1 and 3)."""

import pytest

from test_torch_port_resume import data_dir, port_run  # noqa: F401
from test_torch_port_resume_jax import jax_resumes


@pytest.mark.parametrize("phase", ["rl_agent", "joint"])
def test_jax_trainer_resumes_a_late_port_trainstate(port_run, data_dir,
                                                    phase, capsys, tmp_path):
    jax_resumes(port_run, data_dir, phase, capsys, tmp_path)

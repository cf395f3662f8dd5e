"""dintlint over the port's single-device dense engines and store (one family of the
``python -m dint_tpu_torch.dintlint --all`` matrix; tests/
_torch_dintlint_matrix.py says what each test holds)."""
import pytest

from _torch_dintlint_matrix import check_family_allowlist, check_target, family

NAMES = family("tatp_dense/", "smallbank_dense/", "store/")


@pytest.mark.lint
@pytest.mark.parametrize("name", NAMES)
def test_target_is_clean(name):
    check_target(name)


@pytest.mark.lint
def test_family_allowlist_entries_all_match():
    check_family_allowlist(NAMES)


@pytest.mark.slow
def test_cli_all_and_prune_check():
    """The whole matrix in one process, as the CLI runs it (several
    minutes on the CPU; the family files above are its tier-1 share)."""
    from dint_tpu_torch import dintlint
    assert dintlint.main(["--all"]) == 0
    assert dintlint.main(["--prune-allowlist", "--check"]) == 0

"""The port's docgen (counterpart of ``tests/test_docs.py``'s generated
doc gates), on temporary copies of ``docs/``: the repo's own docs are
the reference's and are never written.

The port's and the reference's ``write_docs`` each run on a copy: the
serving and telemetry spec tables must be equal outside the line that
names each package's command; ``cli.md`` must cover every command and
spec field of the port; a second run changes no byte; ``inject`` refuses
a text without its markers.
"""
import os
import shutil

import pytest

from repro.launch import docgen as jdocgen
from repro_torch import api as tapi
from repro_torch.launch import cli as tcli
from repro_torch.launch import docgen

DOCS = os.path.join(os.path.dirname(__file__), "..", "docs")


def _copy(tmp_path, name):
    dst = tmp_path / name
    shutil.copytree(DOCS, dst)
    return dst


@pytest.fixture()
def both(tmp_path):
    mine, ref = _copy(tmp_path, "port"), _copy(tmp_path, "reference")
    written = docgen.write_docs(str(mine))
    jdocgen.write_docs(str(ref))
    return mine, ref, written


def _drop_notes(text):
    return "\n".join(ln for ln in text.splitlines()
                     if ln not in (docgen.GENERATED_NOTE,
                                   jdocgen.GENERATED_NOTE))


@pytest.mark.parametrize("name", ["serving.md", "observability.md"])
def test_spec_tables_equal_reference(both, name):
    mine, ref, _ = both
    a, b = (mine / name).read_text(), (ref / name).read_text()
    assert _drop_notes(a) == _drop_notes(b)
    assert docgen.GENERATED_NOTE in a


def test_cli_md_covers_every_command_and_spec_field(both):
    mine, _, written = both
    text = (mine / "cli.md").read_text()
    assert set(written) == {str(mine / n) for n in
                            ("cli.md", "serving.md", "observability.md")}
    assert "python -m repro_torch.launch" in text
    for cmd in tcli.COMMANDS:
        assert f"### `{cmd}`" in text, f"command {cmd} undocumented"
    for path in tapi.spec.field_paths():
        assert f"`{path}`" in text, f"spec field {path} undocumented"
    for flag in tcli.ALIASES:
        assert flag in text, f"alias {flag} undocumented"
    assert "`--device`" in text and "`--markdown`" in text


def test_second_run_changes_no_byte(both):
    mine, _, first = both
    assert docgen.write_docs(str(mine)) == first
    for path, content in first.items():
        with open(path) as f:
            assert f.read() == content


def test_inject_requires_markers():
    with pytest.raises(ValueError, match="marker"):
        docgen.inject("no markers here", "x")


def test_bare_directory_gets_cli_md_only(tmp_path):
    written = docgen.write_docs(str(tmp_path / "new"))
    assert list(written) == [str(tmp_path / "new" / "cli.md")]


def test_specs_markdown_writes_the_docs(tmp_path, capsys):
    dst = _copy(tmp_path, "docs")
    tcli.main(["specs", "--out", str(tmp_path / "specs"), "--markdown",
               str(dst)])
    assert (dst / "cli.md").read_text() == docgen.cli_markdown()
    assert '"cli.md"' in capsys.readouterr().out

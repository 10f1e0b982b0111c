"""Port parity: ``aliby_tpu_torch.logparse`` against ``aliby_tpu.logparse`` on
the fixtures of ``tests/test_logparse.py`` and
``tests/test_logparse_production.py``: both packages give equal results,
and the port gives what those tests expect."""

import pytest

import aliby_tpu.logparse as J
import aliby_tpu_torch.logparse as P
from aliby_tpu.logparse.grammar import GRAMMARS as J_GRAMMARS
from aliby_tpu.logparse.grammar import GrammarParser as JParser
from aliby_tpu_torch.logparse.grammar import GRAMMARS, GrammarParser, dispatch_grammar
from test_logparse import ACQ_TXT, SWAINLAB_LOG
from test_logparse_production import FIXTURES

CEXPERIMENT_LOG = """\
11-Mar-2024 14:22:09 Extracting data using extractionParameters: defaultParams
11-Mar-2024 15:01:44 Successfully completed segmenting cells
"""


def test_grammars_are_the_jax_packages():
    assert GRAMMARS == J_GRAMMARS


def test_swainlab_parser(tmp_path):
    f = tmp_path / "exp42.log"
    f.write_text(SWAINLAB_LOG)
    meta = P.parse_swainlab_logs(f)
    assert meta == J.parse_swainlab_logs(f)
    assert meta["channels"] == ["Brightfield", "GFP", "mCherry"]
    assert meta["spatial_locations"]["pos002"] == (600.0, 150.8)
    assert meta["time_settings/ntimepoints"] == 180


@pytest.mark.parametrize("grammar,text", [
    ("multiDGUI_acq_format", ACQ_TXT),
    ("multiDGUI_acq_format", (FIXTURES / "production_acq.txt").read_text()),
    ("multiDGUI_log_format", (FIXTURES / "production_log.txt").read_text()),
    ("cExperiment_log_format", CEXPERIMENT_LOG),
])
def test_grammar_parser(grammar, text):
    got = GrammarParser(grammar).parse(text)
    assert got == JParser(grammar).parse(text)
    assert got


def test_grammar_parser_reads_open_files():
    with (FIXTURES / "production_acq.txt").open() as a, \
            (FIXTURES / "production_acq.txt").open() as b:
        got, want = GrammarParser("multiDGUI_acq_format").parse(a), \
            JParser("multiDGUI_acq_format").parse(b)
    assert got == want
    assert [p["posname"] for p in got["positions"]] == ["pos001", "pos002", "pos003"]
    assert got["pumprate"] == [[4.0, 0.0], [0.0, 4.0]]


@pytest.mark.parametrize("name", ["exp42acq.txt", "exp42log.txt", "cExperiment.txt"])
def test_dispatch_grammar(name):
    from aliby_tpu.logparse.grammar import dispatch_grammar as j_dispatch

    assert dispatch_grammar(name) == j_dispatch(name)


@pytest.mark.parametrize("fixture", ["swainlab_production.log", "production_acq.txt",
                                     "production_log.txt", "."])
def test_parse_microscopy_logs_and_minimal(fixture):
    path = FIXTURES / fixture
    got = P.parse_microscopy_logs(path)
    assert got == J.parse_microscopy_logs(path)
    assert P.MetaData(got).minimal == J.MetaData(got).minimal
    assert P.MetaData.from_logs(path).full == got


def test_minimal_from_written_logs(tmp_path):
    (tmp_path / "exp42.log").write_text(SWAINLAB_LOG)
    (tmp_path / "exp42acq.txt").write_text(ACQ_TXT)
    got = P.MetaData.from_logs(tmp_path).minimal
    assert got == J.MetaData.from_logs(tmp_path).minimal
    with pytest.raises(FileNotFoundError):
        P.parse_microscopy_logs(tmp_path / "nothing")

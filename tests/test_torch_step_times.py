"""``tools/step_times.py``: two chip_smoke logs' train-step lines paired by
key, their ratios and the median ratio of each clock."""

from ml_function_tpu_torch.tools import step_times

BEFORE = """\
xdeepfm training at B=4096 (Criteo width, vocab 100k): 8.000 ms a step, 512000.0 examples/s (median of 20, host clock, batch from host); device time per step 4.0000 ms (CUDA events, median of 10 samples of 5 steps)
xdeepfm_wide_cin training at B=4096 (CIN (512, 128), Criteo width): 10.000 ms a step, 409600.0 examples/s (median of 20); device time per step 8.0000 ms (CUDA events)
only_before training at B=8 (x): 1.000 ms a step, 8.0 examples/s; device time per step 1.0000 ms (CUDA events)
a line that is not a step
"""
AFTER = """\
xdeepfm training at B=4096 (Criteo width, vocab 100k): 6.000 ms a step, 682666.7 examples/s (median of 20, host clock, batch from host); device time per step 4.4000 ms (CUDA events, median of 10 samples of 5 steps)
xdeepfm_wide_cin training at B=4096 (CIN (512, 128), Criteo width): 12.000 ms a step, 341333.3 examples/s (median of 20); device time per step 8.0000 ms (CUDA events)
"""


def test_pairs_the_steps_of_two_logs(tmp_path, capsys):
    before, after = tmp_path / "before.log", tmp_path / "after.log"
    before.write_text(BEFORE)
    after.write_text(AFTER)
    assert step_times.step_times(str(after)) == {
        "xdeepfm training at B=4096 (Criteo width, vocab 100k)": (6.0, 4.4),
        "xdeepfm_wide_cin training at B=4096 (CIN (512, 128), Criteo width)": (12.0, 8.0)}
    assert step_times.main([str(before), str(after)]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].endswith("host 8.000 -> 6.000 ms (0.750), events 4.0000 -> 4.4000 ms (1.100)")
    assert out[1].endswith("(1.200), events 8.0000 -> 8.0000 ms (1.000)")
    assert out[2] == ("2 steps; median ratio, after over before: host clock 0.975, "
                      "events 1.050")
    assert step_times.main([str(before), str(tmp_path / "before.log")]) == 0
    empty = tmp_path / "empty.log"
    empty.write_text("no steps\n")
    assert step_times.main([str(before), str(empty)]) == 1

"""Stage-2 snippet evaluator CLI (reference src/test_trained_model_stage2_cv.py);
the port's copy of the JAX CLI, with `--device`."""

from . import test_stage1


def main(argv=None):
    test_stage1.run("stage2", argv)


if __name__ == "__main__":
    main()

"""ClassEval class-level code-generation evaluation (reference:
applications/eval_classeval.py; dataset FudanSELab/ClassEval at :47-48,
prompt = imports + class constructor + description at :291-303).

On the port:

    python -m lookaheaddecoding_tpu_torch.applications.eval_classeval \\
        [--synthetic] [--device cpu]
"""

from .eval_common import base_parser, run_eval


def load_questions():
    from datasets import load_dataset
    ds = load_dataset("FudanSELab/ClassEval", split="test")
    return [{"question_id": r["task_id"],
             "skeleton": r["skeleton"]} for r in ds]


def build_prompt(q, prior):
    return q["skeleton"]


def main(argv=None):
    args = base_parser().parse_args(argv)
    answer_file = args.answer_file or f"data/classeval/{args.model_id}.jsonl"
    run_eval(args, load_questions(), build_prompt, answer_file)


if __name__ == "__main__":
    main()

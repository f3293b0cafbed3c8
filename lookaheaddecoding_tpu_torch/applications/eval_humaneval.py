"""HumanEval code-completion evaluation (reference:
applications/eval_humaneval.py; problems via human_eval.data.read_problems
at :22,:47-48, raw-prompt completion at :292-293 — code models like
CodeLlama complete the function body directly, no chat template).

On the port:

    python -m lookaheaddecoding_tpu_torch.applications.eval_humaneval \\
        [--synthetic] [--device cpu]
"""

from .eval_common import base_parser, run_eval


def load_questions():
    from human_eval.data import read_problems
    return [{"question_id": tid, "prompt": p["prompt"]}
            for tid, p in read_problems().items()]


def build_prompt(q, prior):
    return q["prompt"]


def main(argv=None):
    args = base_parser().parse_args(argv)
    answer_file = args.answer_file or f"data/humaneval/{args.model_id}.jsonl"
    run_eval(args, load_questions(), build_prompt, answer_file)


if __name__ == "__main__":
    main()

"""MT-Bench evaluation (reference: applications/eval_mtbench.py:23-565).

Questions come from the FastChat MT-Bench question.jsonl (the reference
downloads it in run_mtbench.sh:2); pass --question-file pointing at a local
copy. Two-turn conversations with Llama-2-chat templating.

On the port:

    python -m lookaheaddecoding_tpu_torch.applications.eval_mtbench \\
        [--synthetic] [--device cpu]
"""

import json

from .eval_common import base_parser, run_eval


def load_questions(path):
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def build_prompt(q, prior):
    """Multi-turn [INST] conversation: prior assistant turns are folded back
    into the context (reference eval_mtbench.py:290-304)."""
    parts = []
    for i, turn in enumerate(q["turns"][: len(prior) + 1]):
        if i < len(prior):
            parts.append(f"[INST] {turn} [/INST] {prior[i]} ")
        else:
            parts.append(f"[INST] {turn} [/INST]")
    return "".join(parts)


def main(argv=None):
    ap = base_parser()
    ap.add_argument("--question-file", default="data/mt_bench/question.jsonl")
    ap.add_argument("--bench-name", default="mt_bench")
    args = ap.parse_args(argv)
    answer_file = args.answer_file or (
        f"data/{args.bench_name}/model_answer/{args.model_id}.jsonl")
    questions = load_questions(args.question_file)
    run_eval(args, questions, build_prompt, answer_file,
             num_turns=lambda q: len(q["turns"]))


if __name__ == "__main__":
    main()

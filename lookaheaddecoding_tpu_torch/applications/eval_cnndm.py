"""CNN/DailyMail summarization evaluation (reference:
applications/eval_cnndm.py; dataset load at :46).

On the port:

    python -m lookaheaddecoding_tpu_torch.applications.eval_cnndm \\
        [--synthetic] [--device cpu]
"""

from .eval_common import base_parser, llama2_chat_prompt, run_eval
from .eval_xsum import SUMM_INSTRUCTION


def load_questions(limit=None):
    from datasets import load_dataset
    docs = load_dataset(
        "cnn_dailymail", "3.0.0", split="validation")["article"]
    qs = [{"question_id": i, "article": a} for i, a in enumerate(docs)]
    return qs[:limit] if limit else qs


def build_prompt(q, prior):
    return llama2_chat_prompt(f"{q['article']}\n\n{SUMM_INSTRUCTION}")


def main(argv=None):
    ap = base_parser()
    ap.add_argument("--num-questions", type=int, default=100)
    args = ap.parse_args(argv)
    answer_file = args.answer_file or f"data/cnndm/{args.model_id}.jsonl"
    run_eval(args, load_questions(args.num_questions), build_prompt,
             answer_file)


if __name__ == "__main__":
    main()

"""XSum summarization evaluation (reference: applications/eval_xsum.py).

Loads EdinburghNLP/xsum validation documents (reference eval_xsum.py:46)
with the fixed summarization prompt (:285-301); inputs longer than 2048
tokens are skipped (:308).

On the port:

    python -m lookaheaddecoding_tpu_torch.applications.eval_xsum \\
        [--synthetic] [--device cpu]
"""

from .eval_common import base_parser, llama2_chat_prompt, run_eval

SUMM_INSTRUCTION = (
    "Summarize the above article in one sentence.")


def load_questions(limit=None):
    from datasets import load_dataset
    docs = load_dataset("EdinburghNLP/xsum", split="validation")["document"]
    qs = [{"question_id": i, "document": d} for i, d in enumerate(docs)]
    return qs[:limit] if limit else qs


def build_prompt(q, prior):
    return llama2_chat_prompt(f"{q['document']}\n\n{SUMM_INSTRUCTION}")


def main(argv=None):
    ap = base_parser()
    ap.add_argument("--num-questions", type=int, default=100)
    args = ap.parse_args(argv)
    answer_file = args.answer_file or f"data/xsum/{args.model_id}.jsonl"
    run_eval(args, load_questions(args.num_questions), build_prompt,
             answer_file)


if __name__ == "__main__":
    main()

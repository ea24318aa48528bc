"""Chat prompt templates: the port's own copy of
``ullsam_tpu/models/ullsam/conversation.py`` (whose package ``__init__``
imports jax).

The reference (FastChat-derived ``modeling/conversation.py``) defines 18
separator styles (``conversation.py:15-35``) and registers MPT-style
templates (Hermes-2, internlm2-chat, phi3-chat, internvl2_5,
``conversation.py:340-391``). Every style is a formatter in a dispatch
table; the string goldens ``tests/goldens/conversation_styles.json`` pin
each. ``get_conv_template`` returns a copy; ``build_chat_prompt`` assembles
a chat prompt with the image tokens expanded.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Dict, List, Optional, Tuple


class SeparatorStyle(enum.Enum):
    ADD_COLON_SINGLE = "add_colon_single"
    ADD_COLON_TWO = "add_colon_two"
    ADD_COLON_SPACE_SINGLE = "add_colon_space_single"
    NO_COLON_SINGLE = "no_colon_single"
    NO_COLON_TWO = "no_colon_two"
    ADD_NEW_LINE_SINGLE = "add_new_line_single"
    LLAMA2 = "llama2"
    CHATGLM = "chatglm"
    CHATML = "chatml"
    CHATINTERN = "chatintern"
    DOLLY = "dolly"
    RWKV = "rwkv"
    PHOENIX = "phoenix"
    ROBIN = "robin"
    FALCON_CHAT = "falcon_chat"
    CHATGLM3 = "chatglm3"
    INTERNVL_ZH = "internvl_zh"
    MPT = "mpt"


# -- per-style prompt formatters --------------------------------------------
# Each takes (conv, system_prompt) and returns the assembled prompt string.
# Semantics match the reference's conversation.py:63-251 exactly
# (pinned by string goldens), including the quirks: the trailing space in
# ADD_COLON_SPACE_SINGLE, RWKV's newline normalization, DOLLY's blank line
# after assistant turns, CHATGLM's fullwidth colon + round headers,
# LLAMA2's bare first user message, and INTERNVL_ZH ignoring the system
# *template* (it uses the raw system message).

def _turns(conv):
    """(index, role, message) over the conversation history."""
    for i, (role, message) in enumerate(conv.messages):
        yield i, role, message


def _fmt_add_colon_single(conv, sysp):
    out = [sysp, conv.sep]
    for _, role, msg in _turns(conv):
        out.append(f"{role}: {msg}{conv.sep}" if msg else f"{role}:")
    return "".join(out)


def _fmt_add_colon_two(conv, sysp):
    seps = (conv.sep, conv.sep2)
    out = [sysp, seps[0]]
    for i, role, msg in _turns(conv):
        out.append(f"{role}: {msg}{seps[i % 2]}" if msg else f"{role}:")
    return "".join(out)


def _fmt_add_colon_space_single(conv, sysp):
    out = [sysp, conv.sep]
    for _, role, msg in _turns(conv):
        # an empty slot ends with "role: " (trailing space) in this style
        out.append(f"{role}: {msg}{conv.sep}" if msg else f"{role}: ")
    return "".join(out)


def _fmt_add_new_line_single(conv, sysp):
    out = [sysp + conv.sep if sysp else ""]
    for _, role, msg in _turns(conv):
        out.append(f"{role}\n{msg}{conv.sep}" if msg else f"{role}\n")
    return "".join(out)


def _fmt_no_colon_single(conv, sysp):
    out = [sysp]
    for _, role, msg in _turns(conv):
        out.append(f"{role}{msg}{conv.sep}" if msg else role)
    return "".join(out)


def _fmt_no_colon_two(conv, sysp):
    seps = (conv.sep, conv.sep2)
    out = [sysp]
    for i, role, msg in _turns(conv):
        out.append(f"{role}{msg}{seps[i % 2]}" if msg else role)
    return "".join(out)


def _fmt_rwkv(conv, sysp):
    out = [sysp]
    for _, role, msg in _turns(conv):
        if msg:
            clean = msg.replace("\r\n", "\n").replace("\n\n", "\n")
            out.append(f"{role}: {clean}\n\n")
        else:
            out.append(f"{role}:")
    return "".join(out)


def _fmt_llama2(conv, sysp):
    seps = (conv.sep, conv.sep2)
    out = [sysp if conv.system_message else "[INST] "]
    for i, role, msg in _turns(conv):
        tag = conv.roles[i % 2]
        if msg:
            # the first user message rides bare after the system block
            out.append(f"{msg} " if i == 0 else f"{tag} {msg}{seps[i % 2]}")
        else:
            out.append(tag)
    return "".join(out)


def _fmt_chatglm(conv, sysp):
    # chatglm2 numbers rounds from 1; chatglm from 0
    # (reference conversation.py:146-162)
    base = 1 if conv.name == "chatglm2" else 0
    out = [sysp + conv.sep if sysp else ""]
    for i, role, msg in _turns(conv):
        if i % 2 == 0:
            out.append(f"[Round {i // 2 + base}]{conv.sep}")
        # fullwidth colon (U+FF1A), per the upstream chatglm chat format
        out.append(f"{role}：{msg}{conv.sep}" if msg else f"{role}：")
    return "".join(out)


def _fmt_chatml(conv, sysp):
    out = [sysp + conv.sep + "\n" if sysp else ""]
    for _, role, msg in _turns(conv):
        out.append(f"{role}\n{msg}{conv.sep}\n" if msg else f"{role}\n")
    return "".join(out)


def _fmt_chatglm3(conv, sysp):
    out = [sysp if conv.system_message else ""]
    for _, role, msg in _turns(conv):
        out.append(f"{role}\n {msg}" if msg else role)
    return "".join(out)


def _fmt_chatintern(conv, sysp):
    seps = (conv.sep, conv.sep2)
    out = [sysp]
    for i, role, msg in _turns(conv):
        out.append(f"{role}:{msg}{seps[i % 2]}\n" if msg else f"{role}:")
    return "".join(out)


def _fmt_dolly(conv, sysp):
    seps = (conv.sep, conv.sep2)
    out = [sysp]
    for i, role, msg in _turns(conv):
        if msg:
            out.append(f"{role}:\n{msg}{seps[i % 2]}")
            if i % 2 == 1:  # blank line after each assistant turn
                out.append("\n\n")
        else:
            out.append(f"{role}:\n")
    return "".join(out)


def _fmt_phoenix(conv, sysp):
    out = [sysp]
    for _, role, msg in _turns(conv):
        out.append(f"{role}: <s>{msg}</s>" if msg else f"{role}: <s>")
    return "".join(out)


def _fmt_robin(conv, sysp):
    out = [sysp, conv.sep]
    for _, role, msg in _turns(conv):
        out.append(f"{role}:\n{msg}{conv.sep}" if msg else f"{role}:\n")
    return "".join(out)


def _fmt_falcon_chat(conv, sysp):
    out = [sysp + conv.sep if conv.system_message else ""]
    for _, role, msg in _turns(conv):
        out.append(f"{role}: {msg}{conv.sep}" if msg else f"{role}:")
    return "".join(out)


def _fmt_internvl_zh(conv, sysp):
    # this style uses the raw system MESSAGE, not the formatted template
    seps = (conv.sep, conv.sep2)
    out = [conv.system_message, seps[0]]
    for i, role, msg in _turns(conv):
        out.append(f"{role}: {msg}{seps[i % 2]}" if msg else f"{role}:")
    return "".join(out)


def _fmt_mpt(conv, sysp):
    out = [sysp, conv.sep]
    for _, role, msg in _turns(conv):
        if msg:
            if isinstance(msg, tuple):  # (text, image, ...) rich message
                msg = msg[0]
            out.append(f"{role}{msg}{conv.sep}")
        else:
            out.append(role)
    return "".join(out)


_FORMATTERS = {
    SeparatorStyle.ADD_COLON_SINGLE: _fmt_add_colon_single,
    SeparatorStyle.ADD_COLON_TWO: _fmt_add_colon_two,
    SeparatorStyle.ADD_COLON_SPACE_SINGLE: _fmt_add_colon_space_single,
    SeparatorStyle.NO_COLON_SINGLE: _fmt_no_colon_single,
    SeparatorStyle.NO_COLON_TWO: _fmt_no_colon_two,
    SeparatorStyle.ADD_NEW_LINE_SINGLE: _fmt_add_new_line_single,
    SeparatorStyle.LLAMA2: _fmt_llama2,
    SeparatorStyle.CHATGLM: _fmt_chatglm,
    SeparatorStyle.CHATML: _fmt_chatml,
    SeparatorStyle.CHATINTERN: _fmt_chatintern,
    SeparatorStyle.DOLLY: _fmt_dolly,
    SeparatorStyle.RWKV: _fmt_rwkv,
    SeparatorStyle.PHOENIX: _fmt_phoenix,
    SeparatorStyle.ROBIN: _fmt_robin,
    SeparatorStyle.FALCON_CHAT: _fmt_falcon_chat,
    SeparatorStyle.CHATGLM3: _fmt_chatglm3,
    SeparatorStyle.INTERNVL_ZH: _fmt_internvl_zh,
    SeparatorStyle.MPT: _fmt_mpt,
}


@dataclasses.dataclass
class Conversation:
    name: str
    system_template: str = "{system_message}"
    system_message: str = ""
    roles: Tuple[str, str] = ("USER", "ASSISTANT")
    messages: List[List[Optional[str]]] = dataclasses.field(default_factory=list)
    offset: int = 0
    sep_style: SeparatorStyle = SeparatorStyle.ADD_COLON_SINGLE
    sep: str = "\n"
    sep2: Optional[str] = None
    stop_str: Optional[str] = None
    stop_token_ids: Optional[List[int]] = None

    def get_prompt(self) -> str:
        system_prompt = self.system_template.format(
            system_message=self.system_message)
        fmt = _FORMATTERS.get(self.sep_style)
        if fmt is None:
            raise ValueError(f"unsupported separator style {self.sep_style}")
        return fmt(self, system_prompt)

    def set_system_message(self, system_message: str) -> None:
        self.system_message = system_message

    def append_message(self, role: str, message: Optional[str]) -> None:
        self.messages.append([role, message])

    def update_last_message(self, message: str) -> None:
        self.messages[-1][1] = message

    def to_openai_api_messages(self) -> List[Dict[str, str]]:
        """History as OpenAI-style chat-completion messages
        (reference conversation.py:279-289)."""
        out = [{"role": "system", "content": self.system_message}]
        for i, (_, msg) in enumerate(self.messages[self.offset:]):
            if i % 2 == 0:
                out.append({"role": "user", "content": msg})
            elif msg is not None:
                out.append({"role": "assistant", "content": msg})
        return out

    def copy(self) -> "Conversation":
        return Conversation(
            name=self.name, system_template=self.system_template,
            system_message=self.system_message, roles=self.roles,
            messages=[[r, m] for r, m in self.messages],
            offset=self.offset,
            sep_style=self.sep_style, sep=self.sep, sep2=self.sep2,
            stop_str=self.stop_str, stop_token_ids=self.stop_token_ids)

    def dict(self) -> Dict:
        return {"template_name": self.name,
                "system_message": self.system_message,
                "roles": self.roles, "messages": self.messages,
                "offset": self.offset}


conv_templates: Dict[str, Conversation] = {}


def register_conv_template(template: Conversation,
                           override: bool = False) -> None:
    if not override and template.name in conv_templates:
        raise ValueError(f"{template.name} already registered")
    conv_templates[template.name] = template


def get_conv_template(name: str) -> Conversation:
    return conv_templates[name].copy()


_INTERNVL_SYSTEM = ("你是由上海人工智能实验室联合商汤科技开发的书生多模态大模型，"
                    "英文名叫InternVL, 是一个有用无害的人工智能助手。")

register_conv_template(Conversation(
    name="Hermes-2",
    system_template="<|im_start|>system\n{system_message}",
    system_message=_INTERNVL_SYSTEM,
    roles=("<|im_start|>user\n", "<|im_start|>assistant\n"),
    sep_style=SeparatorStyle.MPT,
    sep="<|im_end|>",
    stop_str="<|endoftext|>",
))

register_conv_template(Conversation(
    name="internlm2-chat",
    system_template="<|im_start|>system\n{system_message}",
    system_message=_INTERNVL_SYSTEM,
    roles=("<|im_start|>user\n", "<|im_start|>assistant\n"),
    sep_style=SeparatorStyle.MPT,
    sep="<|im_end|>",
))

register_conv_template(Conversation(
    name="phi3-chat",
    system_template="<|system|>\n{system_message}",
    system_message=_INTERNVL_SYSTEM,
    roles=("<|user|>\n", "<|assistant|>\n"),
    sep_style=SeparatorStyle.MPT,
    sep="<|end|>",
))

register_conv_template(Conversation(
    name="internvl2_5",
    system_template="<|im_start|>system\n{system_message}",
    system_message=("你是书生·万象，英文名是InternVL，是由上海人工智能实验室、"
                    "清华大学及多家合作单位联合开发的多模态大语言模型。"),
    roles=("<|im_start|>user\n", "<|im_start|>assistant\n"),
    sep_style=SeparatorStyle.MPT,
    sep="<|im_end|>\n",
))


def build_chat_prompt(template_name: str, question: str,
                      history: Optional[List[Tuple[str, str]]] = None,
                      system_message: Optional[str] = None,
                      num_image_token: int = 1024,
                      num_patches_list: Optional[List[int]] = None,
                      img_start_token: str = "<img>",
                      img_end_token: str = "</img>",
                      img_context_token: str = "<IMG_CONTEXT>",
                      has_image: bool = True) -> str:
    """Assemble the full chat prompt with expanded image tokens.

    Mirrors InternVLSAMModel.chat prompt assembly
    (modeling_internvl_sam.py:276-304): append '\n<image>' to a first-turn
    question lacking it, then expand each '<image>' into
    <img> + <IMG_CONTEXT>*num_image_token*num_patches + </img>.
    """
    if has_image and not history and "<image>" not in question:
        question = question + "\n<image>"
    template = get_conv_template(template_name)
    if system_message is not None:
        template.system_message = system_message
    for old_q, old_a in (history or []):
        template.append_message(template.roles[0], old_q)
        template.append_message(template.roles[1], old_a)
    template.append_message(template.roles[0], question)
    template.append_message(template.roles[1], None)
    query = template.get_prompt()
    for num_patches in (num_patches_list or ([1] if has_image else [])):
        image_tokens = (img_start_token
                        + img_context_token * (num_image_token * num_patches)
                        + img_end_token)
        query = query.replace("<image>", image_tokens, 1)
    return query

"""Hand-written judged bilingual eval queries over the generated KB corpus
(copy of ``cmw_rag_tpu/eval/judged_queries.py``).

Mirrors the reference's judged reranker dataset shape — 52+ RU/EN/mixed
support questions with graded relevance (cmw-rag
``rag_engine/docs/analysis/20260321-reranker-benchmark-final.md:39-66``:
38 RU / 8 mixed / 6 EN over 8,231 docs). These 72 queries (42 RU / 16 EN /
14 mixed) were written and judged by the dataset author against the
structured corpus of ``corpus_gen.py``; the grading rule is explicit:

- grade 3 — the article that answers the question directly: same
  (topic, facet), language matching the query, current product version (v5).
  Mixed-language queries accept both languages at grade 3.
- grade 2 — same (topic, facet) but the other language or the previous
  version (v4): the content answers the question, the reader pays a
  translation/version tax.
- grade 1 — same topic, different facet: topically related, does not
  answer the question.
- grade 0 (implicit) — everything else.

Phrasings are deliberately disjoint from the training-pair templates in
``corpus_gen.generate_training_pairs`` so eval measures generalization, not
train-set recall.
"""

from __future__ import annotations

from typing import Any

from cmw_rag_tpu_torch.eval.corpus_gen import (
    CURRENT_VERSION,
    GenArticle,
    generate_eval_queries,
)

# (query, language, topic, facet) — language ∈ {ru, en, mixed}
QUERIES: list[tuple[str, str, str, str]] = [
    # ------------------------------------------------------------- RU (38)
    ("как построить маршрут согласования документа в дизайнере",
     "ru", "process-designer", "setup"),
    ("процесс зависает на шаге и не идёт дальше, куда смотреть",
     "ru", "process-designer", "troubleshooting"),
    ("можно ли запускать процесс из внешней системы по запросу",
     "ru", "process-designer", "api-usage"),
    ("добавить выпадающий список на форму заявки",
     "ru", "forms", "setup"),
    ("форма не сохраняется и ругается на обязательные поля",
     "ru", "forms", "troubleshooting"),
    ("хочу скрыть часть полей формы от рядовых сотрудников",
     "ru", "forms", "permissions-for"),
    ("как связать две таблицы между собой по ключу",
     "ru", "records", "setup"),
    ("пропали записи из таблицы после фильтрации",
     "ru", "records", "troubleshooting"),
    ("создать запись в таблице запросом из другой системы",
     "ru", "records", "api-usage"),
    ("завести нового сотрудника в систему и выслать ему приглашение",
     "ru", "accounts", "setup"),
    ("пользователь заблокирован после неверного пароля, как разблокировать",
     "ru", "accounts", "troubleshooting"),
    ("какие роли нужны чтобы редактировать чужие задачи",
     "ru", "roles-permissions", "setup"),
    ("сотрудник не видит раздел хотя роль назначена",
     "ru", "roles-permissions", "troubleshooting"),
    ("лучшие практики раздачи прав в большой компании",
     "ru", "roles-permissions", "best-practices"),
    ("настроить письмо-напоминание о просроченной задаче",
     "ru", "notifications", "setup"),
    ("уведомления перестали приходить на почту",
     "ru", "notifications", "troubleshooting"),
    ("собрать договор по шаблону word с данными из записи",
     "ru", "templates", "setup"),
    ("в готовом документе вместо значений пустые места",
     "ru", "templates", "troubleshooting"),
    ("где взять токен для запросов к серверу",
     "ru", "rest-api", "setup"),
    ("сервер отвечает кодом 401 на запрос api",
     "ru", "rest-api", "troubleshooting"),
    ("пример запроса который возвращает список записей",
     "ru", "rest-api", "examples"),
    ("оповещать стороннюю систему о смене статуса заявки",
     "ru", "webhooks", "setup"),
    ("загрузить справочник контрагентов из файла csv",
     "ru", "import-export", "setup"),
    ("при импорте ломается кириллица в названиях",
     "ru", "import-export", "troubleshooting"),
    ("настроить ночное создание резервных копий по расписанию",
     "ru", "backup", "setup"),
    ("как перенести систему на новый сервер без потери данных",
     "ru", "backup", "best-practices"),
    ("собрать сводный отчёт по отделам за квартал",
     "ru", "reports", "setup"),
    ("вывести ключевые показатели на стартовый экран руководителя",
     "ru", "dashboards", "setup"),
    ("учитывать праздничные дни при расчёте сроков задач",
     "ru", "calendars", "setup"),
    ("подключить корпоративный почтовый ящик для приёма заявок",
     "ru", "email-integration", "setup"),
    ("включить вход через доменную учётную запись",
     "ru", "ldap-sso", "setup"),
    ("синхронизация с каталогом падает с ошибкой сертификата",
     "ru", "ldap-sso", "troubleshooting"),
    ("переключить интерфейс системы на английский язык",
     "ru", "localization", "setup"),
    ("система стала медленно открывать карточки, что проверить",
     "ru", "performance", "troubleshooting"),
    ("сколько пользователей позволяет наша лицензия и как продлить",
     "ru", "licensing", "setup"),
    ("посчитать длительность между двумя датами в формуле",
     "ru", "scripts-expressions", "examples"),
    ("план обновления системы до новой версии",
     "ru", "version-upgrade", "best-practices"),
    ("кто и когда изменил значение поля в записи",
     "ru", "audit-log", "setup"),
    ("назначить ответственного и срок выполнения по задаче",
     "ru", "tasks", "setup"),
    ("поиск не находит документ по слову из вложения",
     "ru", "search", "troubleshooting"),
    ("настроить эскалацию обращения при нарушении сроков",
     "ru", "sla", "setup"),
    ("сколько вложений можно прикрепить к одной записи",
     "ru", "attachments", "limits"),
    # ------------------------------------------------------------- EN (14)
    ("how do I design an approval route with parallel branches",
     "en", "process-designer", "setup"),
    ("add a required date field to the request form",
     "en", "forms", "setup"),
    ("query records from an external system over http",
     "en", "records", "api-usage"),
    ("bulk create user accounts for a new department",
     "en", "accounts", "setup"),
    ("recommended role model for a multi-team deployment",
     "en", "roles-permissions", "best-practices"),
    ("send a digest of overdue tasks every morning",
     "en", "notifications", "setup"),
    ("generate a pdf contract from a record",
     "en", "templates", "setup"),
    ("api returns 401 unauthorized on every call",
     "en", "rest-api", "troubleshooting"),
    ("notify an external billing system when a deal closes",
     "en", "webhooks", "setup"),
    ("export a table to excel with filters applied",
     "en", "import-export", "setup"),
    ("restore the database from last night's backup",
     "en", "backup", "setup"),
    ("dashboard tiles show stale numbers",
     "en", "dashboards", "troubleshooting"),
    ("single sign-on setup with saml identity provider",
     "en", "ldap-sso", "setup"),
    ("page load is slow on large tables",
     "en", "performance", "troubleshooting"),
    ("enforce a strong password policy with two-factor authentication",
     "en", "security-settings", "setup"),
    ("move the configured data model to the production server",
     "en", "data-model", "migration"),
    # ---------------------------------------------------------- mixed (12)
    ("как настроить webhook при изменении записи",
     "mixed", "webhooks", "setup"),
    ("пример POST запроса к REST API для создания записи",
     "mixed", "rest-api", "examples"),
    ("ошибка import из csv: колонки не совпадают",
     "mixed", "import-export", "troubleshooting"),
    ("настройка SSO через Active Directory",
     "mixed", "ldap-sso", "setup"),
    ("как включить push уведомления в mobile приложении",
     "mixed", "mobile", "setup"),
    ("формула IF для условия в вычисляемом поле",
     "mixed", "scripts-expressions", "examples"),
    ("экспорт отчёта в Excel по расписанию",
     "mixed", "reports", "api-usage"),
    ("backup базы перед обновлением на новую версию",
     "mixed", "backup", "best-practices"),
    ("права доступа к dashboard для топ-менеджмента",
     "mixed", "dashboards", "permissions-for"),
    ("лимит на размер attachment при загрузке файлов",
     "mixed", "attachments", "setup"),
    ("audit log: выгрузка истории изменений через api",
     "mixed", "audit-log", "api-usage"),
    ("timezone в календаре расписаний отображается неверно",
     "mixed", "calendars", "troubleshooting"),
    ("лимит WIP на kanban доске — где настраивается",
     "mixed", "kanban-board", "setup"),
    ("миграция настроек connector между dev и prod средами",
     "mixed", "integrations-ext", "migration"),
]


# Multi-intent queries: (query, language, [(topic, facet), (topic, facet)]).
# Each needs TWO distinct article families to answer — the slice that prices
# sibling expansion's diversity cost (VERDICT r4 missing #4: with one family
# per query, filling half the top-10 with the top-1 anchor's siblings is
# cost-free by construction; these queries pay that cost if it exists).
# Families are deliberately cross-topic so the grade-1 "same topic, other
# facet" rings of the two families never overlap.
MULTI_QUERIES: list[tuple[str, str, list[tuple[str, str]]]] = [
    # ------------------------------------------------------------- RU (16)
    ("настроить импорт контрагентов из csv и уведомлять ответственного о "
     "результате загрузки",
     "ru", [("import-export", "setup"), ("notifications", "setup")]),
    ("сделать резервную копию перед обновлением и составить план перехода "
     "на новую версию",
     "ru", [("backup", "setup"), ("version-upgrade", "best-practices")]),
    ("получить токен для api и настроить вебхук на изменение записи",
     "ru", [("rest-api", "setup"), ("webhooks", "setup")]),
    ("добавить поле на форму заявки и ограничить его видимость по ролям",
     "ru", [("forms", "setup"), ("roles-permissions", "setup")]),
    ("построить маршрут согласования с напоминанием исполнителю по почте",
     "ru", [("process-designer", "setup"), ("notifications", "setup")]),
    ("создавать записи в таблице через api и видеть кто их потом менял",
     "ru", [("records", "api-usage"), ("audit-log", "setup")]),
    ("собрать квартальный отчёт и вывести его показатели на дашборд",
     "ru", [("reports", "setup"), ("dashboards", "setup")]),
    ("включить вход через домен и массово завести учётные записи отдела",
     "ru", [("ldap-sso", "setup"), ("accounts", "setup")]),
    ("назначить сроки по задачам и настроить эскалацию при просрочке",
     "ru", [("tasks", "setup"), ("sla", "setup")]),
    ("сформировать договор по шаблону и отправить его на электронную "
     "подпись",
     "ru", [("templates", "setup"), ("digital-signature", "setup")]),
    ("принимать заявки с корпоративного почтового ящика в службу поддержки",
     "ru", [("email-integration", "setup"), ("helpdesk", "setup")]),
    ("система медленно открывает карточки — включить диагностические логи "
     "и найти причину",
     "ru", [("performance", "troubleshooting"),
            ("logs-diagnostics", "setup")]),
    ("настроить производственный календарь и учёт отпусков сотрудников",
     "ru", [("calendars", "setup"), ("vacations", "setup")]),
    ("при импорте появляются дубли — как настроить контроль качества "
     "данных",
     "ru", [("import-export", "troubleshooting"), ("data-quality", "setup")]),
    ("настроить мониторинг узлов кластера и оповещения о сбоях",
     "ru", [("monitoring-alerts", "setup"), ("clustering-ha", "setup")]),
    ("включить шифрование данных и установить сертификаты на сервер",
     "ru", [("encryption", "setup"), ("certificates", "setup")]),
    # -------------------------------------------------------------- EN (8)
    ("publish record change events to a message queue with an example api "
     "request",
     "en", [("message-queues", "setup"), ("rest-api", "examples")]),
    ("schedule nightly database maintenance together with backups",
     "en", [("database-admin", "setup"), ("backup", "setup")]),
    ("form labels show the wrong language, how do i configure localization",
     "en", [("forms", "troubleshooting"), ("localization", "setup")]),
    ("define kpi metrics and show them on an executive dashboard",
     "en", [("kpi-metrics", "setup"), ("dashboards", "setup")]),
    ("deploy the system in docker behind a load balancer",
     "en", [("docker-deploy", "setup"), ("load-balancing", "setup")]),
    ("user keeps getting locked out, set a sane password policy",
     "en", [("accounts", "troubleshooting"), ("security-settings", "setup")]),
    ("run an etl pipeline automatically on a nightly schedule",
     "en", [("etl-pipelines", "setup"), ("scheduled-jobs", "setup")]),
    ("print a record card using a custom template, any example",
     "en", [("printing", "setup"), ("templates", "examples")]),
    # ----------------------------------------------------------- mixed (8)
    ("webhook не срабатывает — где включить debug logs",
     "mixed", [("webhooks", "troubleshooting"),
               ("logs-diagnostics", "setup")]),
    ("настроить mobile приложение и push notifications о новых задачах",
     "mixed", [("mobile", "setup"), ("notifications", "setup")]),
    ("api отвечает ssl error — как установить certificate",
     "mixed", [("rest-api", "troubleshooting"), ("certificates", "setup")]),
    ("запускать import из csv по расписанию через api",
     "mixed", [("import-export", "api-usage"), ("scheduled-jobs", "setup")]),
    ("настроить kanban доску и сроки task для команды",
     "mixed", [("kanban-board", "setup"), ("tasks", "setup")]),
    ("план project на диаграмме gantt — с чего начать",
     "mixed", [("gantt-chart", "setup"), ("projects", "setup")]),
    ("интеграция telephony с карточкой клиента в crm",
     "mixed", [("telephony", "setup"), ("crm", "setup")]),
    ("search не находит документ по вложению — есть ли limit на размер "
     "attachment",
     "mixed", [("search", "troubleshooting"), ("attachments", "limits")]),
]


def judge_query(articles: list[GenArticle], language: str, topic: str,
                facet: str) -> dict[str, float]:
    """Resolve (topic, facet, language) to graded kbId judgments per the
    module-docstring rule."""
    grades: dict[str, float] = {}
    for a in articles:
        if a.topic != topic:
            continue
        if a.facet == facet:
            lang_match = (language == "mixed") or (a.language == language)
            if lang_match and a.version == CURRENT_VERSION:
                grades[a.kb_id] = 3.0
            else:
                grades[a.kb_id] = 2.0
        else:
            grades[a.kb_id] = 1.0
    return grades


def judge_query_multi(articles: list[GenArticle], language: str,
                      families: list[tuple[str, str]]) -> dict[str, float]:
    """Graded judgments for a multi-intent query: each (topic, facet)
    family is judged by the single-family rule, merged by max grade."""
    grades: dict[str, float] = {}
    for topic, facet in families:
        for kb, g in judge_query(articles, language, topic, facet).items():
            grades[kb] = max(grades.get(kb, 0.0), g)
    return grades


def build_judged_dataset(articles: list[GenArticle],
                         include_generated: bool = True,
                         include_multi: bool = True) -> dict[str, Any]:
    """The committed-JSON shape consumed by eval runners:
    ``{"queries": [{query, language, topic, facet, judgments}], "corpus":
    [{kb_id, title, content}]}`` (same shape as ``eval.dataset``).

    ``include_generated`` adds the template-held-out queries from
    ``corpus_gen.generate_eval_queries`` (phrasings disjoint from every
    training template) after the hand-written set, tagged
    ``source: generated``. ``include_multi`` adds the two-family
    multi-intent queries (``MULTI_QUERIES``), tagged ``source: multi``
    and carrying a ``families`` list instead of one (topic, facet)."""
    queries = []
    rows: list[tuple[str, str, str, str, str]] = [
        (*q, "hand") for q in QUERIES]
    if include_generated:
        rows += [(*q, "generated") for q in generate_eval_queries()]
    for q, lang, topic, facet, source in rows:
        queries.append({
            "query": q,
            "language": lang,
            "topic": topic,
            "facet": facet,
            "source": source,
            "judgments": judge_query(articles, lang, topic, facet),
        })
    if include_multi:
        for q, lang, families in MULTI_QUERIES:
            queries.append({
                "query": q,
                "language": lang,
                "topic": families[0][0],
                "facet": families[0][1],
                "families": [list(f) for f in families],
                "source": "multi",
                "judgments": judge_query_multi(articles, lang, families),
            })
    corpus = [{"kb_id": a.kb_id, "title": a.title, "content": a.body,
               "tags": list(a.tags)}
              for a in articles]
    return {"queries": queries, "corpus": corpus}
